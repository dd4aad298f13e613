"""krust_tpu's own test files, run against the port.

``load(name, stated)`` reads ``tests/<name>.py`` as text, replaces the word
``krust_tpu`` with ``krust_tpu_torch`` (a word-boundary match: a
``krust_tpu_torch`` already there is left alone) and the reference's
harness files that a test loads by path with the port's twins (``TWINS``).
In the files that reach ``krust_tpu``'s (hi, lo) call forms (``FORMED``:
the kernel, codec, flat-path and table suites) the module paths of
``FORMS`` name the forms layer (``tests/torch_reference_forms.py``) first,
and ``jax.numpy`` is numpy. It then compiles the result under the reference file's own path (so ``__file__``,
``fixtures/`` and tracebacks point to the original, and ``assert`` is
rewritten as pytest rewrites a test file's) and returns the names it
defines: its tests, classes, fixtures and ``pytestmark``. A
``tests/test_torch_ref_<name>.py`` puts them into its module:

    STATED = {"TestClass::test_name": "the reason"}
    globals().update(load("test_api", STATED))

``STATED`` names the reference's tests that check a stated difference of
the port (``Class::method``, a whole ``Class`` or a module-level
``function``); each is marked ``xfail(strict=True)``, so a listed test
that starts to pass fails. Beside each entry its file holds a test of the
port's counterpart behaviour, named in its ``BESIDE`` dict. Nothing else
is marked, skipped or deselected here: the reference's own ``slow`` and
``skipif`` marks stand as they are.

The reference files are not edited: a test added there runs on the port
on the next run. ``LOADED`` lists the files run this way; ``EXCLUDED``
names the others, each with its reason (``tests/test_torch_ref_meta.py``
fails when a reference file is in neither). This module imports nothing of
``krust_tpu`` and no ``jax``.

On a machine without JAX (``tests/conftest.py`` imports it) the loaded
files run with ``--noconftest``, conftest's fixtures coming from
:class:`NoConftest`:

    python tests/torch_reference_suite.py OUT.json [pytest arguments]

runs pytest in this process and writes its outcomes, its seconds, each
test file's outcomes and seconds, and the launches of the port's kernels
over the run to ``OUT.json`` (chip_smoke.py phase 11 runs the loaded files
this way on the GPU, where the forms send every form to the kernels).
"""

from __future__ import annotations

import ast
import fnmatch
import gzip
import json
import os
import re
import shutil
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))

#: the reference test files that run against the port, one
#: ``test_torch_ref_<name without test_>.py`` each
LOADED = (
    "test_api",
    "test_builder",
    "test_chunked",
    "test_cli",
    "test_codec",
    "test_epoch_table",
    "test_flat",
    "test_histogram",
    "test_index",
    "test_jellyfish_compat",
    "test_kmer",
    "test_native",
    "test_output",
    "test_pallas",
    "test_pallas_fused",
    "test_pallas_merge",
    "test_pallas_rle",
    "test_properties",
    "test_reader",
    "test_review_fixes",
    "test_sniff_and_sharded_api",
    "test_table",
    "test_tracing",
)

_PORT_FILES = "the port's own differential files hold the same function against krust_tpu's"

#: reference test files (fnmatch patterns) that are not loaded, and why
EXCLUDED = {
    "test_kernel_geometry": "Pallas tile geometry (KRUST_MERGE_CHUNK, KRUST_RLE_CHUNK) "
                            "of the TPU kernels, which the port does not read; the CUDA "
                            "kernels have their own (test_torch_slice.py, "
                            "test_torch_sizing.py)",
    "test_sharded": "JAX meshes of virtual XLA-CPU devices and shard_map; "
                    + _PORT_FILES + " (test_torch_local_mesh.py, test_torch_sharded.py)",
    "test_multihost": "jax.distributed processes over XLA-CPU devices; "
                      + _PORT_FILES + " (test_torch_multihost.py)",
}

#: the reference files that reach krust_tpu's (hi, lo) call forms: their
#: import lines name the forms layer (tests/torch_reference_forms.py) for
#: the module paths of FORMS, and ``import jax.numpy as jnp`` becomes
#: ``import numpy as jnp`` (they use ``asarray``, ``zeros``, ``arange`` and
#: the dtypes of it)
FORMED = (
    "test_codec",
    "test_epoch_table",
    "test_flat",
    "test_pallas",
    "test_pallas_fused",
    "test_pallas_merge",
    "test_pallas_rle",
    "test_table",
)

#: krust_tpu module paths -> the forms layer's, in FORMED files
FORMS = {f"krust_tpu.{m}": f"torch_reference_forms.{m}" for m in (
    "ops.pallas_rle", "ops.pallas_merge", "ops.pallas_codec", "ops.pallas_fused",
    "ops.count", "ops.table", "ops.codec", "io.packer", "models.engines",
)}

#: a harness file a reference test loads by path -> the port's twin
TWINS = {"fuzz_targets.py": "fuzz_targets_torch.py"}

_WORD = re.compile(r"\bkrust_tpu\b")


def path_of(name: str) -> str:
    """The reference file ``tests/<name>.py``."""
    return os.path.join(HERE, name + ".py")


def _formed(text: str) -> str:
    """``text`` with FORMS applied: ``krust_tpu.a.b`` and ``from krust_tpu.a
    import b`` name the forms layer, and jnp is numpy."""
    for ref, forms in FORMS.items():
        parent, _, leaf = ref.rpartition(".")
        text = re.sub(rf"\b{re.escape(ref)}\b", forms, text)
        text = re.sub(rf"\bfrom {re.escape(parent)} import {leaf}\b",
                      f"from {forms.rpartition('.')[0]} import {leaf}", text)
    return text.replace("import jax.numpy as jnp", "import numpy as jnp")


def port_source(name: str) -> str:
    """The reference file's text with the port's names in it."""
    with open(path_of(name), encoding="utf-8") as f:
        text = f.read()
    if name in FORMED:
        text = _formed(text)
    text = _WORD.sub("krust_tpu_torch", text)
    for ref, port in TWINS.items():
        text = text.replace(f'"{ref}"', f'"{port}"')
    return text


def reference_ids(name: str) -> set[str]:
    """Every test id the reference file defines: ``function``, ``Class``
    and ``Class::method``."""
    with open(path_of(name), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    ids = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name.startswith("test"):
            ids.add(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            ids.add(node.name)
            ids.update(f"{node.name}::{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and m.name.startswith("test"))
    return ids


def _compiled(name: str):
    source = port_source(name)
    path = path_of(name)
    tree = ast.parse(source, path)
    try:
        from _pytest.assertion.rewrite import rewrite_asserts

        rewrite_asserts(tree, source.encode(), path)
    except (ImportError, TypeError):  # pytest's private API moved: plain asserts
        pass
    return compile(tree, path, "exec")


def load(name: str, stated: dict[str, str] | None = None) -> dict:
    """The names ``tests/<name>.py`` defines, run against the port, with
    the ``stated`` tests marked ``xfail(strict=True)``."""
    namespace = {"__name__": f"{__name__}.{name}", "__file__": path_of(name),
                 "__builtins__": __builtins__}
    exec(_compiled(name), namespace)
    for test_id, reason in (stated or {}).items():
        owner, _, attr = test_id.rpartition("::")
        holder = namespace[owner] if owner else namespace
        obj = getattr(holder, attr) if owner else holder[attr]
        marked = pytest.mark.xfail(strict=True, reason=reason)(obj)
        if owner:
            setattr(holder, attr, marked)
        else:
            holder[attr] = marked
    return {key: value for key, value in namespace.items() if not key.startswith("__")}


def excluded(name: str) -> str | None:
    """The reason ``tests/<name>.py`` is not loaded, or None."""
    for pattern, reason in EXCLUDED.items():
        if fnmatch.fnmatch(name, pattern):
            return reason
    return None


class NoConftest:
    """``tests/conftest.py``'s fixtures, for a run with ``--noconftest``."""

    @pytest.fixture(scope="session")
    def fixtures_dir(self, tmp_path_factory):
        """Fixture dir containing the plain files plus generated .gz twins."""
        src_dir = os.path.join(HERE, "fixtures")
        d = tmp_path_factory.mktemp("fixtures")
        for name in os.listdir(src_dir):
            src = os.path.join(src_dir, name)
            shutil.copy(src, d / name)
            if name in ("simple.fa", "simple.fq"):
                with open(src, "rb") as f_in, gzip.open(d / (name + ".gz"), "wb") as f_out:
                    f_out.write(f_in.read())
        return d

    @pytest.fixture()
    def simple_fa(self, fixtures_dir):
        return str(fixtures_dir / "simple.fa")

    @pytest.fixture()
    def simple_fq(self, fixtures_dir):
        return str(fixtures_dir / "simple.fq")


class _Outcomes:
    """The run's outcomes as pytest's summary counts them, in all and per
    test file (with the seconds of the file's tests, setup and teardown
    included)."""

    KEYS = ("passed", "failed", "error", "skipped", "xfailed", "xpassed", "deselected")

    def __init__(self):
        self.counts = {}
        self.files: dict[str, dict] = {}
        self._seconds: dict[str, float] = {}

    def pytest_runtest_logreport(self, report):
        path = report.nodeid.split("::")[0]
        self._seconds[path] = self._seconds.get(path, 0.0) + report.duration

    def pytest_terminal_summary(self, terminalreporter):
        stats = terminalreporter.stats
        self.counts = {key: len(stats.get(key, ())) for key in self.KEYS}
        for path, seconds in self._seconds.items():
            self.files[path] = dict.fromkeys(self.KEYS[:-1], 0) | {"seconds": seconds}
        for key in self.KEYS[:-1]:
            for report in stats.get(key, ()):
                path = getattr(report, "nodeid", "").split("::")[0]
                if path in self.files:
                    self.files[path][key] += 1


def _kernels() -> dict:
    """The port's kernel wrappers, each with its ``launches`` counter."""
    from krust_tpu_torch.ops.codec import encode_dense
    from krust_tpu_torch.ops.fused_codec import encode_windows
    from krust_tpu_torch.ops.merge import merge_sorted, merge_sorted_keys
    from krust_tpu_torch.ops.rle import rle_compact

    return {"encode_windows": encode_windows, "rle_compact": rle_compact,
            "merge_sorted": merge_sorted, "encode_dense": encode_dense,
            "merge_sorted_keys": merge_sorted_keys}


def main(argv: list[str]) -> int:
    out, *args = argv
    sys.path.insert(0, os.path.dirname(HERE))
    kernels = _kernels()
    for fn in kernels.values():
        fn.launches = 0
    outcomes = _Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", *args],
                     plugins=[NoConftest(), outcomes])
    seconds = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump({"rc": int(rc), **outcomes.counts, "seconds": seconds,
                   "launches": {name: fn.launches for name, fn in kernels.items()},
                   "files": outcomes.files}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
