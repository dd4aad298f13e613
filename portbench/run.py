"""One run of one cell of the port's benchmark.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the cell's input file, made from ``--seed`` on the card into a
temporary directory (under ``TMPDIR``), and one warm-up pass of the
entry, which builds the kernels on a checkout's first run. The window:
the entry run back to back on that file for ``--seconds`` (the last pass
starts before they have passed), each pass from the file to the exact
host table, plus the configuration's output; each pass's table is freed
before the next pass starts, as in a user's run of one count. After the
window: the reference counts the same file on the card, and the last
pass's table and every pass's output are compared with it exactly.

The last line of standard output is one JSON object; with ``--trace 0``
its metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read under ``torch.profiler``. Exits non-zero, and
prints no result, without as many CUDA devices as the cell asks for, or
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import compare, gen, reference, spec, trace

#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "krust_tpu")
#: the port's launch counters, read to record each cell's route
COUNTERS = {"encode_windows": "krust_tpu_torch.ops.fused_codec",
            "encode_dense": "krust_tpu_torch.ops.codec",
            "rle_compact": "krust_tpu_torch.ops.rle",
            "merge_sorted": "krust_tpu_torch.ops.merge"}
GIB = float(1 << 30)
_IMPORTED_AT = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (/proc; else since import)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED_AT


def host_peak_bytes() -> int:
    """The process's peak resident set so far (``ru_maxrss``). No kernel
    the benchmark runs on lets a process reset it, so a window's reading
    is the peak up to its end. Set-up and window hold one pass's table at
    a time, so the reading is the peak of one pass (the result line gives
    the reading at the window's start beside it)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _launches() -> dict:
    out = {}
    for name, module in COUNTERS.items():
        mod = sys.modules.get(module)
        if mod is not None:
            out[name] = getattr(mod, name).launches
    return out


class Window:
    """What the per-layer readers read of the measured window."""

    def __init__(self):
        self.seconds = 0.0
        self.k = 0           # the configuration's k
        self.bases = 0       # input bases of the passes completed
        self.windows = 0     # windows counted, from the reference's table
        self.distinct = 0    # distinct entries, from the reference's table
        self.count_s = 0.0   # the benchmark's clock around the count entry
        self.output_s = None  # ... around the output, where there is one
        self.spans: dict[str, float] = {}
        self.trace: trace.DeviceTrace | None = None


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, setup_age=process_age_s) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object
    (``checks`` last). ``setup_age`` gives the seconds of set-up so far."""
    cfg, mix = cell.config, cell.traffic
    entry = spec.entry(mix["entry"])
    has_output = cfg.get("output") is not None
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        path = os.path.join(tmp, "input" + mix["suffix"])
        before_input_s, s0 = setup_age(), time.perf_counter()
        made = gen.write_input(path, seed, device, cfg, mix)
        bases = made["bases"]
        s1 = time.perf_counter()
        warm = entry.run(path, cfg)  # warm-up: builds and loads every kernel
        if has_output:
            entry.output(warm, cfg)
        del warm
        setup_parts = {"before_input_s": before_input_s, "input_s": s1 - s0,
                       "warmup_s": time.perf_counter() - s1}
        readers = {m["name"]: spec.metric_reader(m["name"]) for m in cell.per_layer} \
            if traced else {}
        spans: dict[str, float] = {}

        def collect(kind, name, fields):
            if kind == "span":
                spans[name] = spans.get(name, 0.0) + fields["elapsed_s"]

        win = Window()
        win.k = cfg["k"]
        outputs, failed, attempted, ok, pass_s, last = [], 0, 0, 0, [], None
        launches0 = _launches()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        host_at_start = host_peak_bytes()
        setup_s = setup_age()
        if traced:
            from torch.profiler import ProfilerActivity, profile

            from krust_tpu_torch.utils import tracing

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            tracing.add_collector(collect)
            prof.start()
        t0 = time.perf_counter()
        with torch.profiler.record_function(trace.WINDOW):
            while True:
                attempted += 1
                last = None  # the previous pass's table goes before this pass
                c0 = time.perf_counter()
                try:
                    with torch.profiler.record_function("portbench.count"):
                        result = entry.run(path, cfg)
                    c1 = time.perf_counter()
                    if has_output:
                        with torch.profiler.record_function("portbench.output"):
                            outputs.append(entry.output(result, cfg))
                        win.output_s = (win.output_s or 0.0) + time.perf_counter() - c1
                except Exception:  # a failed pass is counted and reported
                    failed += 1
                    traceback.print_exc()
                else:
                    win.count_s += c1 - c0
                    pass_s.append(time.perf_counter() - c0)
                    ok += 1
                    last = result
                    del result
                if time.perf_counter() - t0 >= seconds:
                    break
            if device.type == "cuda":
                torch.cuda.synchronize()
        t1 = time.perf_counter()
        if traced:
            prof.stop()
            tracing.remove_collector(collect)
        peak_device = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        peak_host = host_peak_bytes()
        launches = {n: v - launches0.get(n, 0) for n, v in _launches().items()}
        loaded = forbidden_modules()
        win.seconds, win.bases, win.spans = t1 - t0, ok * bases, spans
        if traced:
            from torch.autograd import DeviceType

            names = set(spans) | {"portbench.count", "portbench.output"}
            win.trace = trace.reduce(prof.events(), names, DeviceType.CUDA, DeviceType.CPU)
            del prof  # its events are no longer needed

        # the check, once the program's device state is freed
        c0 = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        data = torch.from_numpy(np.fromfile(path, np.uint8)).to(device)
        ref_keys, ref_counts = reference.count_table(
            data, mix["suffix"] == ".fq", cfg["k"], cfg["min_quality"])
        del data
        if last is None:  # the last pass raised: no table to compare
            codes = counts = np.zeros(0, np.uint64)
        else:
            codes, counts = last.codes, last.counts
        checks = {"entries_off": (compare.entries_off(codes, counts, ref_keys, ref_counts), 0),
                  "passes_failed": (failed, 0)}
        if has_output:
            checks["outputs_off"] = (compare.outputs_off(
                outputs, reference.histogram_bytes(ref_counts)), 0)
        win.windows = ok * int(ref_counts.sum())
        win.distinct = ok * ref_keys.numel()
        del last, codes, counts, ref_keys, ref_counts
        check_s = time.perf_counter() - c0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if traced:
        values = {n: readers[n](win) for n in readers}
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    else:
        e2e = {"mbases_per_s": ok * bases / 1e6 / win.seconds,
               "peak_device_gib": peak_device / GIB,
               "peak_host_gib": peak_host / GIB,
               "setup_s": setup_s}
        values = {m["name"]: e2e.get(m["name"]) for m in cell.end_to_end}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    metrics = {n: {"value": v, "unit": units[n]} for n, v in values.items() if v is not None}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak_device}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = win.trace.busy_s, win.trace.window_s
        out["breakdown"] = win.trace.breakdown()
    out["input"] = made
    out["seconds"] = dict(setup_parts, window_s=win.seconds, pass_s=pass_s,
                          check_s=check_s)
    out["host_peak_bytes"] = {"window_start": host_at_start, "window_end": peak_host}
    out["route"] = launches
    out["forbidden_modules"] = loaded
    out["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    except ImportError as e:
        print(f"portbench: the program is not importable: {e}", file=sys.stderr)
        return 1
    if out["forbidden_modules"]:
        print(f"portbench: loaded in this process: {out['forbidden_modules']}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
