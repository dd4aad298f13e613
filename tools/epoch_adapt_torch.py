"""The adaptive epoch target on the card: read sets counted with
``EpochTable.ADAPT_DUP_TARGET`` at 8, 16 and 32 and with adaptation off.

    python3 tools/epoch_adapt_torch.py [--sets phase4 deep] [--reps 3] [--seed 0]
                                       [--out _ab/epoch_adapt.jsonl]

Read sets, 250 bp reads at k = 21 as chip_smoke.py writes them, sized in
default epochs (``epoch_entry_limit`` of the card): ``phase4`` is
chip_smoke.py phase 4's, 1.25 epochs at 32x over a random genome, held
against the native core; ``deep`` is 3 epochs over a 16 Mbase genome (about
230x), the high-duplication input adaptation is for. Each set is counted
through ``api.count_with_input`` on the device engine in turns (8, 16, 32,
off; the order rotates each repetition, so drift falls on every setting
alike). "off" pins ``KRUST_EPOCH_ENTRIES`` at the default epoch, which
disables adaptation. The first epoch's distinct count is read when the
second flushes, so an adapted epoch applies from the third on. Each count
prints seconds, peak device memory, the epoch flushes and the adapted epoch
(``epoch_limit_adapted``); every table must equal the set's first. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (write_reads, _native_counts, _gpu_line)

SETTINGS = (8, 16, 32, "off")
#: read set: (default epochs, genome bases or None for bases / 32, held
#: against the native core)
SETS = {"phase4": (1.25, None, True), "deep": (3.0, chip_smoke.GENOME, False)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sets", nargs="+", choices=sorted(SETS), default=["phase4", "deep"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="_ab/epoch_adapt.jsonl")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("epoch_adapt_torch: no CUDA device", file=sys.stderr)
        return 2
    os.environ["KRUST_ENGINE"] = "device"
    from krust_tpu_torch.ops import table as table_mod
    from krust_tpu_torch.utils import tracing

    dev = torch.device("cuda", 0)
    gpu = chip_smoke._gpu_line()
    limit = table_mod.epoch_entry_limit(dev)
    rng = np.random.default_rng(args.seed)
    events: list = []
    tracing.add_collector(lambda kind, name, f: events.append((name, f))
                          if name in ("epoch_flushed", "epoch_limit_adapted") else None)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "w")

    def emit(obj):
        line = json.dumps({**obj, "gpu": gpu})
        print(line, flush=True)
        out.write(line + "\n")

    with tempfile.TemporaryDirectory() as tmp:
        for name in args.sets:
            epochs, genome, native = SETS[name]
            bases = int(limit * epochs) // chip_smoke.READ_LEN * chip_smoke.READ_LEN
            path = os.path.join(tmp, "reads.fa")
            chip_smoke.write_reads(path, rng, bases, genome or bases // 32)
            first = chip_smoke._native_counts(path, 21) if native else None
            for rep in range(args.reps):
                order = SETTINGS[rep % 4:] + SETTINGS[: rep % 4]
                for setting in order:
                    if setting == "off":
                        os.environ["KRUST_EPOCH_ENTRIES"] = str(limit)
                    else:
                        table_mod.EpochTable.ADAPT_DUP_TARGET = setting
                    events.clear()
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    try:
                        t0 = time.perf_counter()
                        got = chip_smoke._port_counts(path, 21)
                        sec = time.perf_counter() - t0
                    finally:
                        os.environ.pop("KRUST_EPOCH_ENTRIES", None)
                        table_mod.EpochTable.ADAPT_DUP_TARGET = 16
                    if first is None:
                        first = got
                    chip_smoke._assert_equal(got, first, f"{name} target={setting}")
                    adapted = [f["new"] for n, f in events if n == "epoch_limit_adapted"]
                    emit({"set": name, "epochs": epochs, "bases": bases, "epoch_entries": limit,
                          "target": setting, "rep": rep, "seconds": sec,
                          "peak_device_bytes": torch.cuda.max_memory_allocated(),
                          "flushes": sum(n == "epoch_flushed" for n, _ in events),
                          "adapted_epoch_entries": adapted[0] if adapted else None,
                          "distinct": got.distinct, "equal": True})
            os.unlink(path)
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
