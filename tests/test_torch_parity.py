"""The port's public surface against ``krust_tpu``'s, name for name.

Every module of ``krust_tpu`` (walked with ``pkgutil``, not listed by hand)
has a module of the same path in ``krust_tpu_torch``, unless
``MODULE_DIFFERENCES`` names it. In each:

- **names**: ``krust_tpu``'s public names (no leading underscore, modules
  left out) and the public attributes of its classes, minus the port's,
  equal ``NAME_DIFFERENCES[module]`` exactly: a new gap fails, and so does
  a listed name the port has since gained;
- **__all__**: where ``krust_tpu``'s module has one, the port's holds it,
  apart from the stated name differences;
- **signatures**: every public function, class and method present in both
  takes the same parameters (names, order, kinds and defaults) as
  ``inspect.signature`` gives for ``krust_tpu``'s, unless
  ``SIGNATURE_DIFFERENCES[module]`` names it (again both ways). A
  port-only parameter is allowed where it cannot change a reference call:
  keyword-only, or after the reference's parameters, with a default.

Then the reference's call forms on the port: ``EpochTable(21, 4)``,
``DeviceTable()``, ``epoch_entry_limit()``, ``exchange(8)`` and
``except CapacityOverflow``. Each reason below is the one ``ROADMAP.md``
Queue C states for the difference.
"""

import enum
import importlib
import inspect
import pkgutil
import types

import numpy as np
import pytest
import torch

import krust_tpu
from krust_tpu.ops.table import EpochTable as JaxEpochTable
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.keys import keys_to_codes
from krust_tpu_torch.parallel.mesh import init_distributed, make_mesh
from krust_tpu_torch.parallel.sharded import EpochShardedTable, ShardedTable
from krust_tpu_torch.utils.config import default_device

REF, PORT = "krust_tpu", "krust_tpu_torch"
MODULES = [REF] + sorted(m.name for m in pkgutil.walk_packages(krust_tpu.__path__, REF + "."))

#: modules of krust_tpu that have no module of the same path in the port
MODULE_DIFFERENCES = {
    "krust_tpu.ops.pallas_codec": "K4 is a CUDA kernel, csrc/codec.cu, behind "
                                  "ops/codec.encode_dense",
    "krust_tpu.ops.pallas_fused": "K1 is a CUDA kernel, csrc/fused_codec.cu, behind "
                                  "ops/fused_codec.encode_windows",
    "krust_tpu.ops.pallas_merge": "K3 and K5 are CUDA kernels, csrc/merge.cu, behind "
                                  "ops/merge.merge_sorted and merge_sorted_keys",
    "krust_tpu.ops.pallas_rle": "K2 is a CUDA kernel, csrc/rle.cu, behind ops/rle.rle_compact",
}

_BYTE_PACKER = "the byte-per-base packer is removed for good; the dense path packs 2 bits a base"
_FLAT_UNPACK = "the unfused flat branch is not ported; K1 reads the flat stream itself"
_JAX_MESH = "JAX mesh names; the port's mesh is a list of torch devices, with no named axes"
_SHARD_MAP = ("an import of krust_tpu's shard_map bodies; the port's exchange does not use "
              "it there")
_AXIS = "the chip axis of krust_tpu's [n_dev, L] parts; a port table holds one slot's parts"
_PENDING = ("krust_tpu's EpochTable inherits it from DeviceTable; the port's EpochTable is "
            "no subclass")
_TOGGLES = ("a toggle could only route CUDA tensors through plain code; passing one raises "
            "TypeError")

#: per module: krust_tpu's public names (``Class.attr`` for a class's
#: attributes) that the port does not have, each with its reason
NAME_DIFFERENCES = {
    "krust_tpu.io": {"PackedBatch": _BYTE_PACKER, "blockize": _BYTE_PACKER,
                     "pack_buffer": _BYTE_PACKER},
    "krust_tpu.io.packer": {"PackedBatch": _BYTE_PACKER, "blockize": _BYTE_PACKER,
                            "pack_buffer": _BYTE_PACKER, "flat_batch_widths": _BYTE_PACKER},
    "krust_tpu.models.engines": {"PackedBatch": _BYTE_PACKER},
    "krust_tpu.ops.codec": {"unpack_flat_blocks": _FLAT_UNPACK},
    "krust_tpu.ops.table": {"DeviceTable.AXIS": _AXIS, "EpochTable.AXIS": _AXIS,
                            "EpochTable.PENDING_ENTRY_LIMIT": _PENDING},
    "krust_tpu.parallel.mesh": {"DATA_AXIS": _JAX_MESH},
    "krust_tpu.parallel.sharded": {
        "DATA_AXIS": _JAX_MESH, "NamedSharding": _JAX_MESH, "P": _JAX_MESH,
        "EPOCH_WINDOW_LIMIT": _SHARD_MAP, "INVALID_CODE": _SHARD_MAP,
        "encode_blocks": _SHARD_MAP, "flat_batches": _SHARD_MAP, "merge_runs": _SHARD_MAP,
        "round_pow2": _SHARD_MAP, "pack_buffer": _BYTE_PACKER,
        "ShardedTable.AXIS": _AXIS, "EpochShardedTable.AXIS": _AXIS,
        "EpochShardedTable.PENDING_ENTRY_LIMIT": _PENDING,
    },
    "krust_tpu.utils.config": {"EngineConfig.use_pallas": _TOGGLES,
                               "EngineConfig.use_fused_codec": _TOGGLES},
}

_ONE_KEY = "(hi, lo) uint32 planes are one biased key tensor, whose dtype carries the width"
_NO_INTERPRET = ("interpret is not taken (there is no interpret mode), and raises "
                 "TypeError")

#: per module: functions, classes (their constructors) and ``Class.method``
#: whose parameters differ from krust_tpu's, each with its reason
SIGNATURE_DIFFERENCES = {
    "krust_tpu.ops.count": {"count_runs": _ONE_KEY, "count_unique": _ONE_KEY,
                            "merge_runs": _ONE_KEY, "merge_runs_presorted": _ONE_KEY,
                            "merge_weighted": _ONE_KEY},
    "krust_tpu.ops.table": {"DeviceTable.add": _ONE_KEY, "EpochTable.add": _ONE_KEY,
                            "EpochTable": _NO_INTERPRET},
    "krust_tpu.parallel.mesh": {"make_mesh": "axis names a JAX mesh axis; the port's "
                                             "second and third are device and devices"},
    "krust_tpu.parallel.sharded": {
        "ShardedTable.add": _ONE_KEY, "EpochShardedTable.add": _ONE_KEY,
        "EpochShardedTable": _NO_INTERPRET + "; slot, the table's mesh slot, is in its place",
    },
    "krust_tpu.utils.config": {"EngineConfig": "no use_pallas or use_fused_codec field, "
                                               "so the fields after them shift; use_flat "
                                               "and the port's device come last"},
}


def _port_module(name: str):
    return importlib.import_module(PORT + name[len(REF):])


def _public(obj) -> set:
    return {n for n in dir(obj)
            if not n.startswith("_") and not isinstance(getattr(obj, n), types.ModuleType)}


def _defined_in(obj, module: str) -> bool:
    return getattr(obj, "__module__", None) == module


def _name_gaps(module: str) -> set:
    """krust_tpu's public names of ``module`` the port's lacks, and the
    public attributes the port lacks of each class defined in it."""
    ref, port = importlib.import_module(module), _port_module(module)
    gaps = _public(ref) - _public(port)
    for name in sorted(_public(ref) & _public(port)):
        r, p = getattr(ref, name), getattr(port, name)
        if inspect.isclass(r) and _defined_in(r, module):
            gaps |= {f"{name}.{a}" for a in _public(r) - set(dir(p))}
    return gaps


def _callables(module: str):
    """(label, reference callable, port callable) for every public function
    and class defined in ``module`` that the port's module has too, and
    every public method (and ``__init__``, labelled by the class) of those
    classes that the port's class has."""
    ref, port = importlib.import_module(module), _port_module(module)
    for name in sorted(_public(ref) & _public(port)):
        r, p = getattr(ref, name), getattr(port, name)
        if not (callable(r) and _defined_in(r, module)):
            continue
        yield name, r, p
        if inspect.isclass(r):
            for a in sorted(_public(r)):
                rm, pm = inspect.getattr_static(r, a), inspect.getattr_static(p, a, None)
                if inspect.isfunction(rm) and inspect.isfunction(pm):
                    yield f"{name}.{a}", rm, pm


def _norm(default):
    if default is inspect.Parameter.empty:
        return "required"
    if isinstance(default, enum.Enum):  # each package has its own enum classes
        return type(default).__name__, default.value
    return default


def _params(fn) -> list | None:
    try:
        sig = inspect.signature(fn)
    except ValueError:  # an exception class with the builtin constructor
        return None
    return [(p.name, p.kind, _norm(p.default)) for p in sig.parameters.values()]


def _differs(ref_fn, port_fn) -> bool:
    """Whether a call written for ``ref_fn`` could mean something else to
    ``port_fn``: the reference's parameters must open the port's, and every
    port-only parameter must come after them (or be keyword-only) with a
    default."""
    ref, port = _params(ref_fn), _params(port_fn)
    if ref is None or port is None:
        return ref != port
    return port[: len(ref)] != ref or any(d == "required" for _, _, d in port[len(ref):])


def test_modules_are_walked():
    """The walk finds the whole package, the dicts name only walked
    modules, and no module is listed both as missing and with entries."""
    assert len(MODULES) == 36 and "krust_tpu.parallel.sharded" in MODULES
    listed = set(MODULE_DIFFERENCES) | set(NAME_DIFFERENCES) | set(SIGNATURE_DIFFERENCES)
    assert listed <= set(MODULES)
    assert not set(MODULE_DIFFERENCES) & (set(NAME_DIFFERENCES) | set(SIGNATURE_DIFFERENCES))
    reasons = [*MODULE_DIFFERENCES.values(),
               *(r for d in (*NAME_DIFFERENCES.values(), *SIGNATURE_DIFFERENCES.values())
                 for r in d.values())]
    assert all(r and "\n" not in r for r in reasons)


@pytest.mark.parametrize("module", MODULES)
def test_module_names(module):
    """krust_tpu's names minus the port's are exactly the stated ones."""
    if module in MODULE_DIFFERENCES:
        with pytest.raises(ModuleNotFoundError):
            _port_module(module)
        return
    assert _name_gaps(module) == set(NAME_DIFFERENCES.get(module, {}))


@pytest.mark.parametrize("module", [m for m in MODULES if m not in MODULE_DIFFERENCES
                                    and hasattr(importlib.import_module(m), "__all__")])
def test_all_holds_the_references(module):
    """The port's ``__all__`` holds krust_tpu's, apart from stated names."""
    ref, port = importlib.import_module(module), _port_module(module)
    missing = set(ref.__all__) - set(getattr(port, "__all__", ()))
    assert missing <= set(NAME_DIFFERENCES.get(module, {}))
    assert all(hasattr(port, n) for n in port.__all__)


@pytest.mark.parametrize("module", [m for m in MODULES if m not in MODULE_DIFFERENCES])
def test_signatures(module):
    """Same parameters as krust_tpu's, apart from the stated callables."""
    stated = SIGNATURE_DIFFERENCES.get(module, {})
    seen, differ = set(), set()
    for label, r, p in _callables(module):
        seen.add(label)
        if _differs(r, p):
            differ.add(label)
    assert differ == set(stated), "listed: a stated difference is gone, or a new one is unlisted"
    assert set(stated) <= seen


def test_the_checks_see_a_gap(monkeypatch):
    """A name or parameter removed from the port shows as a gap."""
    from krust_tpu_torch.ops import codec
    from krust_tpu_torch.parallel import sharded

    monkeypatch.delattr(codec, "split64")
    assert _name_gaps("krust_tpu.ops.codec") == {"split64", "unpack_flat_blocks"}

    def exchange(self):  # the form before capacity_factor
        return None

    monkeypatch.setattr(sharded._Exchanged, "exchange", exchange)
    assert _differs(krust_tpu.parallel.ShardedTable.exchange, sharded.ShardedTable.exchange)
    assert not _differs(exchange, sharded.ShardedTable.exchange)


def test_differs_allows_only_harmless_extras():
    def ref(a, b=1):
        pass

    def kw_extra(a, b=1, *, device=None):
        pass

    def tail_extra(a, b=1, c=0):
        pass

    def shifted(a, c=0, b=1):
        pass

    def required_extra(a, b=1, c=None, *, d):
        pass

    def new_default(a, b=2):
        pass

    assert not _differs(ref, kw_extra) and not _differs(ref, tail_extra)
    assert _differs(ref, shifted) and _differs(ref, required_extra)
    assert _differs(ref, new_default)


# --- the reference's call forms ------------------------------------------------------


def test_table_call_forms():
    """``EpochTable(21, 4)``, ``DeviceTable()`` and ``epoch_entry_limit()``
    mean what they mean in krust_tpu; the device is keyword-only and
    defaults to the first CUDA device when one is visible."""
    port, ref = table_mod.EpochTable(21, 4, device="cpu"), JaxEpochTable(21, 4)
    assert (port._k, port._max_parts) == (ref._k, ref._max_parts) == (21, 4)
    table = table_mod.DeviceTable(device="cpu")
    assert (table._k, table._max_parts, table._device) == (32, 8, torch.device("cpu"))
    assert table_mod.DeviceTable()._device == default_device()
    assert table_mod.EpochTable()._device == default_device()
    assert table_mod.epoch_entry_limit() == table_mod.epoch_entry_limit(default_device())
    with pytest.raises(TypeError):
        table_mod.EpochTable(21, 4, interpret=False)
    with pytest.raises(TypeError):
        table_mod.EpochTable(21, 4, False)
    with pytest.raises(TypeError):
        table_mod.DeviceTable(21, 8, "cpu")


def test_capacity_overflow_imports():
    from krust_tpu_torch.parallel import CapacityOverflow
    from krust_tpu_torch.parallel.sharded import CapacityOverflow as Same

    assert CapacityOverflow is Same and issubclass(CapacityOverflow, RuntimeError)
    try:
        raise CapacityOverflow("never raised by the port")
    except CapacityOverflow as e:
        assert "port" in str(e)


def _filled(table_cls, mesh, seed):
    rng = np.random.default_rng(seed)
    table = table_cls(21, mesh, max_parts=2)
    raw = [torch.from_numpy(rng.integers(-(1 << 63), -(1 << 63) + 4000, 2500))
           for _ in range(3)]
    for keys in raw:
        table.add(keys, *(() if table_cls is EpochShardedTable else (None,)), 2500)
    return table, np.unique(keys_to_codes(torch.cat(raw).numpy(), 21), return_counts=True)


@pytest.fixture
def one_rank_group(tmp_path):
    init_distributed(f"file://{tmp_path / 'pg'}", rank=0, world_size=1, backend="gloo")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def _exchange_forms(table_cls):
    mesh = make_mesh(device="cpu")
    out = []
    for args in ((), (8,), (1,)):
        table, exp = _filled(table_cls, mesh, seed=3)
        o_keys, o_cnt, n = table.exchange(*args)
        got = keys_to_codes(o_keys[:n].numpy(), 21), o_cnt[:n].numpy()
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        out.append(got)
    table, _ = _filled(table_cls, mesh, seed=3)
    with pytest.raises(ValueError):
        table.exchange(0)
    return out


@pytest.mark.parametrize("table_cls", [ShardedTable, EpochShardedTable])
def test_exchange_takes_capacity_factor(table_cls):
    """``exchange(8)`` and ``exchange(1)`` give ``exchange()``'s shard in a
    world of one; ``exchange(0)`` raises, as no rung of capacity below 1
    exists in krust_tpu's ladder either."""
    _exchange_forms(table_cls)


@pytest.mark.parametrize("table_cls", [ShardedTable, EpochShardedTable])
def test_exchange_takes_capacity_factor_in_a_group(one_rank_group, table_cls):
    """The same in a one-rank gloo group, where the exchange's collectives
    run."""
    _exchange_forms(table_cls)
