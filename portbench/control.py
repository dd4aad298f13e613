"""The comparison's readings on several seeds, in one process: the
program's (the lower reading) and the control's (the upper).

    python -m portbench.control --workload <cell> --seeds 1,2,3 [--device cuda]

For each seed: the cell's input, one pass of the program's entry (and its
output), the reference's table, and the control: the reference put in the
program's place with its keys narrowed to 32 bits (``int32`` for
``int64``, the int32 key of k <= 16 taken at the cell's k), so that
distinct k-mers sharing their low 32 bits merge. Prints one JSON line a
seed with every number the run compares, for the program and the control.
The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from . import compare, gen, reference, spec

NARROW_BITS = 32


def readings(cell: spec.Cell, seed: int, device: torch.device) -> dict:
    cfg, mix = cell.config, cell.traffic
    entry = spec.entry(mix["entry"])
    fastq = mix["suffix"] == ".fq"
    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        path = os.path.join(tmp, "input" + mix["suffix"])
        gen.write_input(path, seed, device, cfg, mix)
        result = entry.run(path, cfg)
        out = entry.output(result, cfg) if cfg.get("output") else None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        data = torch.from_numpy(np.fromfile(path, np.uint8)).to(device)
        keys, counts = reference.count_table(data, fastq, cfg["k"], cfg["min_quality"])
        ref_hist = reference.histogram_bytes(counts)
        program = {"entries_off": compare.entries_off(result.codes, result.counts, keys,
                                                      counts)}
        if out is not None:
            program["outputs_off"] = compare.outputs_off([out], ref_hist)
        del result
        c_keys, c_counts = reference.count_table(data, fastq, cfg["k"], cfg["min_quality"],
                                                 narrow_bits=NARROW_BITS)
        c_codes = reference.codes_of(c_keys).cpu().numpy().view(np.uint64)
        control = {"entries_off": compare.entries_off(
            c_codes, c_counts.cpu().numpy().view(np.uint64), keys, counts)}
        if out is not None:
            control["outputs_off"] = compare.outputs_off(
                [reference.histogram_bytes(c_counts)], ref_hist)
        return {"workload": cell.name, "seed": seed, "distinct": keys.numel(),
                "windows": int(counts.sum()), "program": program, "control": control}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(spec.benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
