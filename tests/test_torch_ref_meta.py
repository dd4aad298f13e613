"""The loaded reference suites (tests/torch_reference_suite.py) hold what
they claim: every reference test file is loaded or excluded with a
reason, every stated difference names a reference test and a port test
beside it, and no port module imports JAX or krust_tpu."""

import ast
import glob
import importlib
import json
import os
import subprocess
import sys

import pytest

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
    """A reference test body that imports JAX runs only as a stated
    difference: the port's machine has no JAX (chip_smoke.py phase 11)."""
    module = importlib.import_module(_ref_file(name))
    with open(suite.path_of(name), encoding="utf-8") as f:
        tree = ast.parse(f.read())
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
    paths += [os.path.join(REPO, "chip_smoke.py"), suite.__file__]
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
    files = ["tests/test_torch_ref_histogram.py", "tests/test_torch_ref_review_fixes.py"]
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
    # the plain versions run on the CPU: no kernel launched
    assert got["launches"] == dict.fromkeys(
        ["encode_windows", "rle_compact", "merge_sorted", "encode_dense", "merge_sorted_keys"], 0)
