"""krust_tpu's call forms over the port, for its loaded kernel and table
test files.

``krust_tpu``'s kernel, count and table functions take uint32 (hi, lo)
planes, uint32 counts and numpy or JAX arrays; the port's take one biased
key tensor (:mod:`krust_tpu_torch.ops.keys`) and int32 counts. This module
presents the reference's functions by their ``krust_tpu`` module paths, as
the package ``torch_reference_forms`` (``torch_reference_forms.ops.
pallas_rle`` stands for ``krust_tpu.ops.pallas_rle``), so that
``tests/torch_reference_suite.py`` can load the reference's test files
against the port with their import lines mapped (its ``FORMS``).

Each form converts layouts and does nothing else:

- (hi, lo) planes go to biased keys and back with ``ops/keys.py``
  (sentinel keys come back as (SENT, SENT)); a one-key (lo-only) plane
  maps to int32 keys, ``0xFFFFFFFF`` being the sentinel, and its hi plane
  comes back synthesised from lo; uint32 counts are viewed as int32 and
  back;
- the inputs go to :func:`krust_tpu_torch.utils.config.default_device`
  (the CPU under ``KRUST_PLATFORM=cpu``, as conftest.py sets it; the card
  where CUDA is visible and ``KRUST_PLATFORM`` unset), the outputs come
  back as numpy arrays in the reference's layout: full length, the
  reference's tail, ``n_unique`` as an int;
- ``interpret=`` is taken and ignored;
- each form calls exactly one port function, the kernel's wrapper (never
  its ``*_plain`` version), so on CUDA tensors the kernel runs; no form
  sorts, deduplicates, clamps or retries.

Each form's docstring names the ``krust_tpu`` function it stands for, by
file:line. Any other name of a mapped module falls through to the port's
module of the same path, and so does an assignment to one (a test's
``monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", ...)`` reaches the
port's engine). Two kinds of helper are not forms: numpy copies of
functions the port removed for good that the reference's tests build their
inputs with (``io.packer.blockize``, ``ops.codec.unpack_flat_blocks``), and
stand-ins for removed names that a reference file imports at its top
(``ABSENT``), which raise when called.

``CH`` is a CUDA tile, not the TPU chunk: 2048 int64 entries, K2's tile
(``csrc/rle.cu``, ``krust_rle_tile(8)``) and K3's (``csrc/merge.cu``,
``krust_merge_tile(8)``), so the reference's sizes ``CH``, ``2 * CH``,
1023 / 1024 / 1025 and ``5 * 1024 + 17`` land on and across the CUDA
tiles' edges.

Test code: it imports numpy, torch and krust_tpu_torch only (no JAX, no
krust_tpu: it runs on the card's host in chip_smoke.py phase 11) and adds
no name to the port.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.machinery
import sys
import types
from dataclasses import dataclass

import numpy as np
import torch

from krust_tpu_torch.kmer import INVALID_CODE
from krust_tpu_torch.ops import codec, count, fused_codec, merge, rle, table
from krust_tpu_torch.ops.keys import keys_from_step, parts_from_numpy, parts_to_numpy, split_keys
from krust_tpu_torch.utils.config import default_device

#: the module is a package of the reference's module paths (see _Finder)
__path__: list[str] = []

SENT = 0xFFFFFFFF
#: the CUDA kernels' tile in int64 entries (module docstring)
CH = 2048
#: the key width of a form that takes no k: int64 keys hold every (hi, lo)
WIDE = 32
#: the one-key width: int32 keys of the lo plane
ONE_KEY = 16


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tensor(x, dtype) -> torch.Tensor:
    """An array-like on the default device."""
    arr = np.ascontiguousarray(_numpy(x).astype(dtype, copy=False))
    return torch.from_numpy(arr).to(default_device())


def _keys(hi, lo, k: int, device=None) -> torch.Tensor:
    """(hi, lo) planes (hi None: the one-key lo plane) -> biased keys on
    ``device`` (None: the default device)."""
    part = (_numpy(lo),) if hi is None else (_numpy(hi), _numpy(lo))
    return keys_from_step(part, k).to(default_device() if device is None else device)


def _counts(cnt) -> torch.Tensor | None:
    """uint32 counts -> int32 of the same bits."""
    return None if cnt is None else _tensor(_numpy(cnt).astype(np.uint32).view(np.int32), np.int32)


def _table(out, k: int, zero_tail: bool):
    """A port table ``(keys, counts, n_unique)`` -> the reference's ``(hi,
    lo, cnt, n_unique)``: past ``n_unique`` the sentinel pair, or zeros
    where the reference scrubs its padding."""
    keys, cnt, n_dev = out
    n = int(n_dev)
    hi, lo, c = parts_to_numpy(keys, cnt, k)
    if zero_tail:
        hi[n:] = 0
        lo[n:] = 0
    return hi, lo, c, n


# --- ops.pallas_rle ---------------------------------------------------------


def rle_compact(hi, lo, cnt=None, interpret=False, one_key=False):
    """krust_tpu/ops/pallas_rle.py:366 rle_compact, on K2
    (``ops/rle.rle_compact``): int64 keys of (hi, lo), or with ``one_key``
    int32 keys of lo (``hi`` None) and a hi plane synthesised from lo."""
    k = ONE_KEY if one_key else WIDE
    out = rle.rle_compact(_keys(None if one_key else hi, lo, k), _counts(cnt))
    return _table(out, k, zero_tail=False)


# --- ops.pallas_merge -------------------------------------------------------


def merge_sorted(a, b, interpret=False):
    """krust_tpu/ops/pallas_merge.py:248 merge_sorted, on K5
    (``ops/merge.merge_sorted_keys``): two sorted uint32 arrays."""
    return _numpy(merge.merge_sorted_keys(_tensor(a, np.uint32), _tensor(b, np.uint32)))


def merge_sorted_kv(ah, al, ac, bh, bl, bc, interpret=False):
    """krust_tpu/ops/pallas_merge.py:522 merge_sorted_kv, on K3's int64
    keys (``ops/merge.merge_sorted``)."""
    dev = default_device()
    a = parts_from_numpy(_numpy(ah), _numpy(al), _numpy(ac), WIDE, dev)
    b = parts_from_numpy(_numpy(bh), _numpy(bl), _numpy(bc), WIDE, dev)
    return parts_to_numpy(*merge.merge_sorted(*a, *b), WIDE)


def merge_sorted_lv(al, ac, bl, bc, interpret=False):
    """krust_tpu/ops/pallas_merge.py:414 merge_sorted_lv, on K3's int32
    keys (``ops/merge.merge_sorted``): the one-key (lo, cnt) merge."""
    dev = default_device()
    a = parts_from_numpy(None, _numpy(al), _numpy(ac), ONE_KEY, dev)
    b = parts_from_numpy(None, _numpy(bl), _numpy(bc), ONE_KEY, dev)
    _, lo, cnt = parts_to_numpy(*merge.merge_sorted(*a, *b), ONE_KEY)
    return lo, cnt


# --- ops.pallas_codec -------------------------------------------------------


def encode_blocks_pallas(codes, k, qual=None, quality_threshold=None, interpret=False):
    """krust_tpu/ops/pallas_codec.py:145 encode_blocks_pallas, on K4's code
    form (``ops/codec.encode_dense(..., codes=True)``): the rows packed to
    K4's (packed2, badbits) layout, the keys split to (hi, lo) with the
    poison words widened to ``valid`` (uint8 0/1, as the reference's). K4's
    input has no quality plane (quality folds into the bad bits on the
    host), so quality arguments raise ``ValueError``, as the reference's
    do."""
    if qual is not None or quality_threshold is not None:
        raise ValueError("K4 reads no quality: it folds into the bad bits before the kernel")
    rows = _tensor(codes, np.uint8)
    w = rows.shape[1] - (k - 1)
    packed2, badbits, w4 = codec.pack_rows(rows, k)
    keys, poison = codec.encode_dense(packed2, badbits, k, w4, codes=True)
    hi, lo, valid = split_keys(keys.view(-1, w4)[:, :w], k, codec.valid_of(poison, w))
    return _numpy(hi), _numpy(lo), _numpy(valid).astype(np.uint8)


# --- ops.pallas_fused -------------------------------------------------------

#: packed bytes after each row in the reference's halo layout
HALO_BYTES = 128


def encode_packed_pallas(main, halo, k, interpret=False, bad=None, emit_hi=True):
    """krust_tpu/ops/pallas_fused.py:258 encode_packed_pallas, on K1
    (``ops/fused_codec.encode_windows``). The reference's main rows are the
    flat packed stream cut at W/4 bytes a row, and row i's halo is the head
    of row i + 1, so the stream is the rows end to end and the last row's
    halo; K1 keys its windows with no invalid base (the reference's kernel
    applies no validity either), and the keys come back as (hi, lo) in the
    reference's plane-separated order (:func:`plane_permute`). The ``bad``
    window mask has no counterpart in K1's input (invalid base positions)
    and raises ``ValueError``."""
    if bad is not None:
        raise ValueError("K1 takes invalid base positions, not a bad-window mask")
    main, halo = _numpy(main), _numpy(halo)
    rows, w4 = main.shape
    n_windows = rows * 4 * w4
    stream = np.concatenate([main.reshape(-1), halo[-1]]) if rows else main.reshape(-1)
    nowhere = np.array([n_windows + k], np.int32)  # an invalid position past the stream
    keys = fused_codec.encode_windows(_tensor(stream, np.uint8), _tensor(nowhere, np.int32),
                                      n_windows, k, n_windows)
    hi, lo, _ = parts_to_numpy(keys, torch.zeros_like(keys, dtype=torch.int32), k)
    hi, lo = (plane_permute(p.reshape(rows, 4 * w4)) for p in (hi, lo))
    return (hi, lo) if emit_hi else lo


def plane_permute(x):
    """krust_tpu/ops/pallas_fused.py:328 plane_permute: window order ->
    the plane-separated order, column r * W/4 + q holding window 4q + r (a
    permutation of the reference's layout, on numpy)."""
    x = _numpy(x)
    rows, w = x.shape
    return x.reshape(rows, w // 4, 4).transpose(0, 2, 1).reshape(rows, w)


# --- ops.count --------------------------------------------------------------


def _valid(valid) -> torch.Tensor:
    return _tensor(_numpy(valid).reshape(-1).astype(bool), bool)


def merge_weighted(hi, lo, weight, valid):
    """krust_tpu/ops/count.py:31 merge_weighted, on ``ops/count.
    merge_weighted``: int64 keys of (hi, lo); zeros past ``n_unique``."""
    out = count.merge_weighted(_keys(hi, lo, WIDE), _counts(weight), _valid(valid))
    return _table(out, WIDE, zero_tail=True)


def count_unique(hi, lo, valid):
    """krust_tpu/ops/count.py:96 count_unique, on ``ops/count.count_unique``:
    int64 keys of (hi, lo); zeros past ``n_unique``."""
    return _table(count.count_unique(_keys(hi, lo, WIDE), _valid(valid)), WIDE, zero_tail=True)


def merge_runs(hi, lo, weight, k):
    """krust_tpu/ops/count.py:108 merge_runs, on ``ops/count.merge_runs`` at
    k's key width; zeros past ``n_unique``."""
    return _table(count.merge_runs(_keys(hi, lo, k), _counts(weight)), k, zero_tail=True)


def merge_runs_presorted(hi, lo, weight):
    """krust_tpu/ops/count.py:180 merge_runs_presorted, on ``ops/count.
    merge_runs_presorted``: int64 keys of (hi, lo), the sentinel pair past
    ``n_unique`` (the reference keeps it there)."""
    out = count.merge_runs_presorted(_keys(hi, lo, WIDE), _counts(weight))
    return _table(out, WIDE, zero_tail=False)


def count_runs(hi, lo, valid, k):
    """krust_tpu/ops/count.py:221 count_runs, on ``ops/count.count_runs`` at
    k's key width: (hi, lo, cnt), each distinct valid key once with its
    count, the entries with count 0 padding (the port's part comes
    compacted to the front, where the reference leaves each count at its
    run's last position)."""
    return parts_to_numpy(*count.count_runs(_keys(hi, lo, k), _valid(valid)), k)


# --- ops.table --------------------------------------------------------------


class DeviceTable(table.DeviceTable):
    """krust_tpu/ops/table.py:240 DeviceTable: the port's, on the default
    device, with the reference's ``add``."""

    def add(self, u_hi, u_lo, u_cnt, n_windows):
        """krust_tpu/ops/table.py:288 DeviceTable.add: (hi, lo, weight)
        planes, weight 0 padding, as keys and int32 weights (padding as
        sentinel keys) of the table's width."""
        keys, cnt = parts_from_numpy(_numpy(u_hi), _numpy(u_lo), _numpy(u_cnt), self._k,
                                     self._device, zero_is_padding=True)
        super().add(keys, cnt, n_windows)


class EpochTable(table.EpochTable):
    """krust_tpu/ops/table.py:650 EpochTable: the port's, on the default
    device; ``interpret`` is taken and ignored."""

    def __init__(self, k=32, max_parts=8, interpret=False):
        super().__init__(k, max_parts)

    def add(self, u_hi, u_lo, u_cnt, n_windows):
        """krust_tpu/ops/table.py:699 EpochTable.add: raw sentinel-keyed
        (hi, lo) windows (``u_hi`` None: the lo plane of k <= 16; ``u_cnt``
        ignored, as the reference ignores it) as keys of the table's
        width."""
        super().add(_keys(u_hi, u_lo, self._k, self._device), n_windows)


# --- ops.codec --------------------------------------------------------------


def encode_blocks(codes, k, qual=None, quality_threshold=None):
    """krust_tpu/ops/codec.py:35 encode_blocks, on ``ops/codec.encode_blocks``
    (the same signature over tensors): the rows and quality on the default
    device, (hi, lo, valid) back as numpy."""
    q = None if qual is None else _tensor(qual, np.uint8)
    hi, lo, valid = codec.encode_blocks(_tensor(codes, np.uint8), k, q, quality_threshold)
    return _numpy(hi), _numpy(lo), _numpy(valid)


def unpack_flat_blocks(packed2, invpos, k, rows, block_windows):
    """A numpy copy of krust_tpu/ops/codec.py:110 unpack_flat_blocks, an
    input builder: a packed flat slice and its invalid positions -> the
    haloed [rows, W + k - 1] base-code rows the codecs take (the unfused
    flat branch is not ported; K1 reads the flat stream itself)."""
    w = block_windows
    packed2, invpos = _numpy(packed2), _numpy(invpos)
    flat = ((packed2[:, None] >> np.array([6, 4, 2, 0], np.uint8)) & 3).reshape(-1)
    flat = flat.astype(np.uint8)
    flat[invpos[(invpos >= 0) & (invpos < flat.shape[0])]] = INVALID_CODE
    target = (rows + 1) * w
    if flat.shape[0] < target:
        flat = np.concatenate([flat, np.full(target - flat.shape[0], INVALID_CODE, np.uint8)])
    ext = flat[:target].reshape(rows + 1, w)
    return np.concatenate([ext[:-1], ext[1:, : k - 1]], axis=1)


# --- io.packer --------------------------------------------------------------


@dataclass
class PackedBatch:
    """A numpy copy of krust_tpu/io/packer.py:31 PackedBatch, the batch of
    :func:`blockize`."""

    codes: np.ndarray
    qual: np.ndarray | None
    n_windows: int
    block_windows: int


def _halo_view(stream, k, w, n_blocks, fill):
    width = w + k - 1
    need = (n_blocks - 1) * w + width if n_blocks > 0 else 0
    if stream.shape[0] < need:
        stream = np.concatenate([stream, np.full(need - stream.shape[0], fill, np.uint8)])
    if n_blocks == 0:
        return np.zeros((0, width), np.uint8)
    view = np.lib.stride_tricks.sliding_window_view(stream, width)[::w][:n_blocks]
    return np.ascontiguousarray(view)


def blockize(codes, qual, k, block_windows=4096, row_multiple=8, min_rows=None):
    """A numpy copy of krust_tpu/io/packer.py:62 blockize, an input builder:
    a flat code stream -> haloed [rows, W + k - 1] base-code rows (the
    byte-per-base packer is removed from the port for good; the dense path
    packs 2 bits a base)."""
    w = block_windows
    t = max(codes.shape[0] - k + 1, 0)
    n_blocks = -(-t // w) if t > 0 else 0
    rows = n_blocks if min_rows is None else max(n_blocks, min_rows)
    rows = max(-(-rows // row_multiple) * row_multiple, row_multiple)
    out_codes = np.full((rows, w + k - 1), INVALID_CODE, np.uint8)
    if n_blocks > 0:
        out_codes[:n_blocks] = _halo_view(codes, k, w, n_blocks, INVALID_CODE)
    out_qual = None
    if qual is not None:
        out_qual = np.full((rows, w + k - 1), 0xFF, np.uint8)
        if n_blocks > 0:
            out_qual[:n_blocks] = _halo_view(qual, k, w, n_blocks, 0xFF)
    return PackedBatch(out_codes, out_qual, t, w)


# --- the modules ------------------------------------------------------------


def _absent(ref: str, reason: str):
    """A stand-in for a removed name that a reference file imports at its
    top: it lets the file load, and raises when called."""

    def absent(*args, **kwargs):
        raise NotImplementedError(f"{ref}: {reason}")

    absent.__doc__ = f"Not in the port: {ref} ({reason})."
    return absent


#: removed names a reference file imports at module level, by module,
#: each with the reference's file:line and the reason it is gone
ABSENT = {
    "io.packer": {"flat_batch_widths": _absent(
        "krust_tpu/io/packer.py:317 flat_batch_widths",
        "the byte-per-base packer's metadata twin is removed for good")},
    "models.engines": {"_count_flat_step": _absent(
        "krust_tpu/models/engines.py:312 _count_flat_step",
        "a private engine step; the port's flat step is K1 alone, ops/fused_codec."
        "encode_windows")},
}

#: the reference's module paths (below ``krust_tpu``) this package presents:
#: their forms, and the port's module each falls through to (None: none)
MODULES = {
    "ops.pallas_rle": ({"rle_compact": rle_compact, "SENT": SENT, "CH": CH}, None),
    "ops.pallas_merge": ({"merge_sorted": merge_sorted, "merge_sorted_kv": merge_sorted_kv,
                          "merge_sorted_lv": merge_sorted_lv, "SENT": SENT, "CH": CH}, None),
    "ops.pallas_codec": ({"encode_blocks_pallas": encode_blocks_pallas}, None),
    "ops.pallas_fused": ({"encode_packed_pallas": encode_packed_pallas,
                          "plane_permute": plane_permute, "HALO_BYTES": HALO_BYTES}, None),
    "ops.count": ({"merge_weighted": merge_weighted, "count_unique": count_unique,
                   "merge_runs": merge_runs, "merge_runs_presorted": merge_runs_presorted,
                   "count_runs": count_runs}, "krust_tpu_torch.ops.count"),
    "ops.table": ({"DeviceTable": DeviceTable, "EpochTable": EpochTable},
                  "krust_tpu_torch.ops.table"),
    "ops.codec": ({"encode_blocks": encode_blocks, "unpack_flat_blocks": unpack_flat_blocks},
                  "krust_tpu_torch.ops.codec"),
    "io.packer": ({"blockize": blockize, "PackedBatch": PackedBatch, **ABSENT["io.packer"]},
                  "krust_tpu_torch.io.packer"),
    "models.engines": (dict(ABSENT["models.engines"]), "krust_tpu_torch.models.engines"),
}
#: the packages above them
PACKAGES = {name.rpartition(".")[0] for name in MODULES}


class _FormsModule(types.ModuleType):
    """A module of forms over a port module: a name it does not define is
    read from the port's module, and assigned or deleted there."""

    def __getattr__(self, name):
        port = self.__dict__.get("_port")
        if port is None or name.startswith("__"):
            raise AttributeError(f"module {self.__name__!r} has no attribute {name!r}")
        return getattr(importlib.import_module(port), name)

    def _forwards(self, name) -> bool:
        return (self.__dict__.get("_port") is not None and name not in self.__dict__
                and not name.startswith("__"))

    def __setattr__(self, name, value):
        if self._forwards(name):
            setattr(importlib.import_module(self._port), name, value)
        else:
            super().__setattr__(name, value)

    def __delattr__(self, name):
        if self._forwards(name):
            delattr(importlib.import_module(self._port), name)
        else:
            super().__delattr__(name)


class _Finder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Imports (and reloads) ``torch_reference_forms.<path>`` for the paths
    of MODULES and their packages."""

    def find_spec(self, fullname, path, target=None):
        prefix, _, rel = fullname.partition(".")
        if prefix != __name__ or not (rel in MODULES or rel in PACKAGES):
            return None
        return importlib.machinery.ModuleSpec(fullname, self, is_package=rel in PACKAGES)

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        rel = module.__name__.partition(".")[2]
        if rel in MODULES:
            names, port = MODULES[rel]
            module.__dict__.update(names, _port=port)
            module.__class__ = _FormsModule


if not any(isinstance(f, _Finder) for f in sys.meta_path):
    sys.meta_path.append(_Finder())
