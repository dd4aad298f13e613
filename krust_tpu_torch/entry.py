"""Check entry points of the port: the one-device counting step and a dry
run of one process counting over several devices.

    python -m krust_tpu_torch.entry [N] [--device cpu]

The port's counterpart of ``__graft_entry__.py``: :func:`entry` returns
the one-device counting step, K1 (``encode_windows``) -> ``torch.sort`` ->
K2 (``rle_compact``), at k = 21 with example arguments made from a seed;
:func:`dryrun_multichip` counts in one process over the first N GPUs
(default: all of them) at k = 21 and k = 13 and raises unless the table
equals the numpy engine's. ``--device cpu`` (or ``KRUST_PLATFORM=cpu``)
runs both on N CPU slots, the kernels' plain versions (a rehearsal
without a GPU).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .io.reader import streams_from_sequences
from .models.engines import NumpyEngine
from .ops.fused_codec import TAIL_BYTES, encode_windows
from .ops.rle import rle_compact
from .parallel.mesh import make_mesh
from .parallel.sharded import count_sharded
from .utils.config import EngineConfig, forced_platform

K = 21


def entry(device=None):
    """Return (fn, example_args): the one-device counting step at k = 21.

    ``fn(packed, invpos)`` turns a slice of 65,536 windows of 2-bit packed
    bases with 64 invalid positions into its distinct table: K1 keys every
    window (the sentinel where a window holds an invalid base), ``torch.sort``
    orders the keys and K2 compacts the runs, giving (keys, counts,
    n_unique). The arguments lie on ``device``: the first GPU unless
    another is named or ``KRUST_PLATFORM=cpu`` asks for the CPU (on the
    CPU the kernels' plain versions run).
    """
    if device is None:
        if forced_platform() == "cpu":
            device = "cpu"
        elif torch.cuda.is_available():
            device = "cuda:0"
        else:
            raise RuntimeError("no CUDA device: entry() runs on a GPU unless "
                               "device= names another or KRUST_PLATFORM=cpu")
    device = torch.device(device)
    n_windows = 1 << 16

    def count_step(packed, invpos):
        keys = encode_windows(packed, invpos, n_windows, K, n_windows)
        return rle_compact(torch.sort(keys).values)

    rng = np.random.default_rng(0)
    packed = rng.integers(0, 256, n_windows // 4 + TAIL_BYTES, dtype=np.uint8)
    invpos = np.sort(rng.choice(n_windows + K - 1, 64, replace=False)).astype(np.int32)
    return count_step, (torch.from_numpy(packed).to(device),
                        torch.from_numpy(invpos).to(device))


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Count in one process over an n-device mesh and check the table.

    The mesh is the first ``n_devices`` GPUs, or ``n_devices`` slots on
    ``device`` when one is named (on the CPU under ``KRUST_PLATFORM=cpu``).
    4n random reads of 200 bases (seed 42) pass through the whole sharded
    path: batches dealt to the slots, the codec and the epoch table on
    each, the in-process hash exchange and the gather. k = 21 (int64 keys)
    and k = 13 (int32 keys) must each equal the numpy engine's table; any
    difference raises.
    """
    if device is None and forced_platform() == "cpu":
        device = "cpu"
    mesh = make_mesh(n_devices, devices=None if device is None else [device] * n_devices)
    rng = np.random.default_rng(42)
    seqs = ["".join(np.array(list("ACGT"))[rng.integers(0, 4, size=200)])
            for _ in range(4 * n_devices)]
    streams = streams_from_sequences(seqs)
    # 256 windows a batch: about three batches a slot
    cfg = EngineConfig(block_windows=128, batch_rows=2)
    lines = []
    for k in (K, 13):
        got = count_sharded(streams, k, mesh=mesh, config=cfg)
        exp = NumpyEngine(cfg).count(streams, k)
        if not (np.array_equal(got.codes, exp.codes)
                and np.array_equal(got.counts, exp.counts)):
            raise AssertionError(f"k={k}: the sharded table != the numpy engine's "
                                 f"({got.distinct} vs {exp.distinct} distinct)")
        lines.append(f"k={k}: {got.distinct} distinct, total {got.total}")
    devices = ", ".join(str(d) for d in mesh.devices)
    print(f"dryrun_multichip OK: {n_devices} devices ({devices}); " + "; ".join(lines))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="devices of the dry run (default: every GPU)")
    ap.add_argument("--device", default=None, help="cpu: N CPU slots, no GPU")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry OK:", [(tuple(t.shape), str(t.dtype)) for t in out])
    n = args.n if args.n is not None else max(torch.cuda.device_count(), 1)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
