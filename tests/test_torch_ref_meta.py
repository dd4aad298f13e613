"""The loaded reference suites (tests/torch_reference_suite.py) hold what
they claim: every reference test file is loaded or excluded with a
reason, every stated difference names a reference test and a port test
beside it, no port module imports JAX or krust_tpu, and the forms layer
(tests/torch_reference_forms.py) names each krust_tpu function it stands
for and calls one port function for it, never a plain version."""

import ast
import glob
import importlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_reference_forms as forms
import torch_reference_suite as suite

TESTS = suite.HERE
REPO = os.path.dirname(TESTS)


def _ref_file(name):
    """The loader of reference file ``name``: ``test_torch_ref_<name without test_>``."""
    return "test_torch_ref_" + name[len("test_"):]


def _defined(tree):
    """The test ids a module's own code defines (as ``suite.reference_ids``)."""
    ids = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ids.add(node.name)
        elif isinstance(node, ast.ClassDef):
            ids.add(node.name)
            ids.update(f"{node.name}::{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)))
    return ids


def test_every_reference_file_is_loaded_or_excluded():
    names = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(TESTS, "test_*.py"))
                   if not os.path.basename(p).startswith("test_torch"))
    assert names
    for name in names:
        assert (name in suite.LOADED) != (suite.excluded(name) is not None), name
    assert set(suite.LOADED) <= set(names)
    loaders = sorted(os.path.basename(p)[:-3]
                     for p in glob.glob(os.path.join(TESTS, "test_torch_ref_*.py")))
    assert loaders == sorted([_ref_file(n) for n in suite.LOADED] + ["test_torch_ref_meta"])


@pytest.mark.parametrize("name", suite.LOADED)
def test_loader_loads_its_file_and_states_only_reference_tests(name):
    module = importlib.import_module(_ref_file(name))
    with open(os.path.join(TESTS, _ref_file(name) + ".py"), encoding="utf-8") as f:
        source = f.read()
    assert f'load("{name}", STATED)' in source
    ref_ids = suite.reference_ids(name)
    assert set(module.STATED) <= ref_ids, set(module.STATED) - ref_ids
    assert all(reason.strip() for reason in module.STATED.values())
    # a port test beside every stated difference, defined by the loader itself
    own = _defined(ast.parse(source))
    assert set(module.BESIDE) == set(module.STATED)
    assert set(module.BESIDE.values()) <= own
    # the loader's own names never shadow a reference test
    assert not own & ref_ids, own & ref_ids


@pytest.mark.parametrize("name", suite.LOADED)
def test_stated_tests_are_strict_xfails(name):
    module = importlib.import_module(_ref_file(name))
    for test_id in module.STATED:
        owner, _, attr = test_id.rpartition("::")
        obj = getattr(getattr(module, owner), attr) if owner else getattr(module, attr)
        marks = [m for m in getattr(obj, "pytestmark", []) if m.name == "xfail"]
        assert [m.kwargs.get("strict") for m in marks] == [True], test_id


def _imported(tree):
    """The absolute module names imported anywhere under ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _imports(path):
    with open(path, encoding="utf-8") as f:
        return list(_imported(ast.parse(f.read(), path)))


def _imports_jax(node) -> bool:
    return any(root == "jax" for root in (m.split(".")[0] for m in _imported(node)))


@pytest.mark.parametrize("name", suite.LOADED)
def test_only_stated_tests_import_jax(name):
    """A reference test body that still imports JAX as loaded (the FORMED
    files' ``jax.numpy`` is numpy) runs only as a stated difference: the
    port's machine has no JAX (chip_smoke.py phase 11)."""
    module = importlib.import_module(_ref_file(name))
    tree = ast.parse(suite.port_source(name))
    assert not any(_imports_jax(node) for node in tree.body
                   if isinstance(node, (ast.Import, ast.ImportFrom)))
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            members = [(node.name, node)]
        elif isinstance(node, ast.ClassDef):
            members = [(f"{node.name}::{m.name}", m) for m in node.body
                       if isinstance(m, ast.FunctionDef)]
        else:
            continue
        for test_id, fn in members:
            stated = test_id in module.STATED or test_id.split("::")[0] in module.STATED
            assert stated or not _imports_jax(fn), test_id


def test_source_is_the_reference_with_the_port_names():
    text = suite.port_source("test_cli")
    assert '"-m", "krust_tpu_torch"' in text and '"krust_tpu"' not in text
    assert "krust_tpu_torch_torch" not in suite.port_source("test_api")
    assert '"fuzz_targets_torch.py"' in suite.port_source("test_properties")


def test_no_port_module_imports_jax_or_krust_tpu():
    paths = sorted(glob.glob(os.path.join(REPO, "krust_tpu_torch", "**", "*.py"),
                             recursive=True))
    paths += [os.path.join(REPO, "chip_smoke.py"), suite.__file__, forms.__file__,
              os.path.join(REPO, "fuzz", "coverage_fuzz_torch.py")]
    assert len(paths) > 30
    for path in paths:
        for module in _imports(path):
            root = module.split(".")[0]
            assert root not in ("jax", "jaxlib", "krust_tpu"), (path, module)


def test_runner_without_conftest(tmp_path):
    """``python tests/torch_reference_suite.py OUT ...``, as chip_smoke.py
    phase 11 runs the loaded files on the GPU: ``--noconftest`` with
    conftest's fixtures from ``NoConftest``, outcomes and launches in OUT."""
    out = tmp_path / "out.json"
    files = ["tests/test_torch_ref_histogram.py", "tests/test_torch_ref_review_fixes.py",
             "tests/test_torch_ref_pallas_merge.py"]
    env = dict(os.environ, KRUST_PLATFORM="cpu")
    env.pop("KRUST_ENGINE", None)
    subprocess.run([sys.executable, os.path.join("tests", "torch_reference_suite.py"),
                    str(out), *files, "-q", "-m", "not slow", "-p", "no:randomly",
                    f"--basetemp={tmp_path / 'run'}"],
                   cwd=REPO, env=env, check=True, timeout=600, capture_output=True)
    got = json.loads(out.read_text())
    assert got["rc"] == 0 and got["passed"] > 10
    assert (got["failed"], got["error"], got["xpassed"]) == (0, 0, 0)
    assert got["xfailed"] == len(importlib.import_module("test_torch_ref_review_fixes").STATED)
    assert got["seconds"] > 0
    assert sorted(got["files"]) == sorted(files)
    assert sum(f["passed"] for f in got["files"].values()) == got["passed"]
    assert all(f["seconds"] > 0 for f in got["files"].values())
    # the plain versions run on the CPU: no kernel launched
    assert got["launches"] == dict.fromkeys(
        ["encode_windows", "rle_compact", "merge_sorted", "encode_dense", "merge_sorted_keys"], 0)


def test_excluded_is_exactly_what_the_port_cannot_load():
    assert sorted(suite.EXCLUDED) == ["test_kernel_geometry", "test_multihost", "test_sharded"]
    assert set(suite.FORMED) <= set(suite.LOADED)


def test_formed_source_names_the_forms_layer():
    text = suite.port_source("test_pallas_rle")
    assert "from torch_reference_forms.ops import pallas_rle" in text
    assert "import numpy as jnp" in text and "jax" not in text
    text = suite.port_source("test_flat")
    assert "import torch_reference_forms.ops.table as table_mod" in text
    assert "from krust_tpu_torch.io.reader import ParsedStreams" in text
    assert "torch_reference_forms" not in suite.port_source("test_api")


def _forms():
    """(path, name, object) of every name the forms layer defines itself,
    the ABSENT stand-ins apart."""
    for path, (names, _) in forms.MODULES.items():
        for name, obj in names.items():
            if (callable(obj) and getattr(obj, "__module__", None) == forms.__name__
                    and name not in forms.ABSENT.get(path, {})):
                yield path, name, obj


_REF_LINE = re.compile(r"(krust_tpu/[\w/]+\.py):(\d+)")


def _names_its_reference(doc: str, name: str) -> bool:
    """Whether ``doc`` names a krust_tpu file:line that defines ``name``."""
    m = _REF_LINE.search(doc or "")
    if not m:
        return False
    with open(os.path.join(REPO, m.group(1)), encoding="utf-8") as f:
        line = f.read().splitlines()[int(m.group(2)) - 1]
    return re.match(rf"\s*(def|class) {re.escape(name)}\b", line) is not None


def test_every_form_names_its_krust_tpu_function_by_file_and_line():
    seen = 0
    for path, name, obj in _forms():
        assert _names_its_reference(obj.__doc__, name), (path, name)
        if isinstance(obj, type) and "add" in vars(obj):
            assert _names_its_reference(obj.add.__doc__, "add"), (path, name)
        seen += 1
    assert seen >= 18
    for path, names in forms.ABSENT.items():
        for name, stand_in in names.items():
            assert _names_its_reference(stand_in.__doc__.partition("Not in the port: ")[2], name)
            with pytest.raises(NotImplementedError):
                stand_in()


#: port modules the forms call into, and their layout helpers (no kernel)
_PORT_MODULES = {"codec", "count", "fused_codec", "merge", "rle"}
_LAYOUT = {"pack_rows", "valid_of"}


def _port_calls(fn: ast.AST) -> list[str]:
    """The port functions a form's body calls: ``<port module>.f(...)`` but
    the layout helpers, and ``super().add(...)``."""
    calls = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            owner = node.func.value
            if isinstance(owner, ast.Name) and owner.id in _PORT_MODULES:
                if node.func.attr not in _LAYOUT:
                    calls.append(f"{owner.id}.{node.func.attr}")
            elif isinstance(owner, ast.Call) and getattr(owner.func, "id", None) == "super":
                calls.append(f"super().{node.func.attr}")
    return calls


def test_forms_call_one_port_function_and_no_plain_version():
    with open(forms.__file__, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    used = {getattr(node, "id", None) or getattr(node, "attr", None) or getattr(node, "name", None)
            for node in ast.walk(tree) if isinstance(node, (ast.Name, ast.Attribute, ast.alias))}
    assert not [name for name in used if name and name.endswith("_plain")]
    defs = {node.name: node for node in ast.walk(tree)
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))}
    builders = {"blockize", "unpack_flat_blocks", "plane_permute", "PackedBatch"}
    checked = 0
    for path, name, obj in _forms():
        node = defs[name]
        if isinstance(obj, type):
            if name in builders:
                continue
            node = next(m for m in node.body if isinstance(m, ast.FunctionDef) and m.name == "add")
            assert _port_calls(node) == ["super().add"], name
        elif name in builders:
            assert _port_calls(node) == [], name
        else:
            assert len(_port_calls(node)) == 1, (name, _port_calls(node))
        checked += 1
    assert checked >= 15


def _int64_tile(source: str) -> int:
    """A kernel source's tile in int64 keys: threads x bytes a thread / 8."""
    with open(os.path.join(REPO, "krust_tpu_torch", "csrc", source), encoding="utf-8") as f:
        text = f.read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", text).group(1))
    per_thread = int(re.search(r"kItems = (\d+) / sizeof\(Key\);", text).group(1))
    return threads * (per_thread // 8)


def test_forms_ch_is_the_cuda_tile():
    """The forms' CH is the int64 tile that csrc/rle.cu and csrc/merge.cu
    declare (tests/test_torch_cuda.py asks the built library on the card)."""
    assert forms.CH == _int64_tile("rle.cu") == _int64_tile("merge.cu") == 2048
    from torch_reference_forms.ops import pallas_merge, pallas_rle

    assert pallas_rle.CH == pallas_merge.CH == forms.CH


def test_forms_module_falls_through_to_the_port(monkeypatch):
    import torch_reference_forms.ops.table as table_mod

    from krust_tpu_torch.ops import table as port_table

    assert table_mod.epoch_entry_limit is port_table.epoch_entry_limit
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 4096)
    assert port_table.EPOCH_WINDOW_LIMIT == 4096
    assert issubclass(table_mod.EpochTable, port_table.EpochTable)
    with pytest.raises(AttributeError):
        table_mod._HBM_CACHE  # noqa: B018
    from torch_reference_forms.ops import pallas_rle

    assert importlib.reload(pallas_rle).rle_compact is forms.rle_compact
    out = pallas_rle.rle_compact(np.array([1, 1, forms.SENT], np.uint32),
                                 np.array([5, 5, forms.SENT], np.uint32))
    assert [a.tolist() for a in out[:3]] == [[1, forms.SENT, forms.SENT],
                                             [5, forms.SENT, forms.SENT], [2, 0, 0]]
    assert out[3] == 1
    assert torch.device(forms.default_device()).type in ("cpu", "cuda")


def test_chip_smoke_reports_every_formed_file():
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    value = next(node.value for node in tree.body if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "PHASE11_FORMED")
    assert sorted(ast.literal_eval(value)) == sorted(suite.FORMED)
