"""Two trees on one card, in turns: chip_smoke.py phases of each.

    python3 tools/ab_chip_smoke.py PARENT_DIR CHANGE_DIR [--phases 1,2]
                                   [--out _ab/ab_chip_smoke.jsonl]

Runs ``python3 chip_smoke.py --phases ...`` in each tree (each builds its
own kernels from its own sources) in the order parent, change, change,
parent, so drift on the card or its host falls on both alike. Every JSON
line of every run goes to ``--out`` with the tree and the turn added. The
last line of standard output is the summary: for each phase-2 row (kernel
and shape), each tree's kernel ms in its turns and the row's bound; for
each counting line of phases 3-10 (its phase, case, table, process group,
mesh, entry, k, bases and quality filter) and phase 11's run of the loaded
reference suites (its files and outcome counts), each tree's seconds. A run
that fails stops the comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: fields of a phase-2 line that are measurements, not the row's shape
_MEASURED = {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_bytes",
             "bound_ops", "max_abs_err", "equal", "gpu", "n_unique", "invalid_positions",
             "launches", "library_call", "phase", "k4_ms", "k4_bound_ms", "valid_share",
             "invalid_windows_lo_nonzero", "k4_count_form_ms", "k4_count_form_bound_ms",
             "code_form_equal"}
#: fields that tell a phase's counting runs apart (a list or a dict is no key)
_CASE = ("phase", "case", "table", "process_group", "mesh", "entry", "k", "bases",
         "min_quality", "files", "passed", "failed", "errors", "xfailed", "skipped")
#: shape fields an older tree's lines may lack, with the value they had
_DEFAULTS = {"encode_windows": {"invalid_share": 0.01}, "rle_compact": {"stream": "random"},
             "merge_sorted": {"parts": "random"}}


def row_key(line: dict) -> str:
    shape = dict(_DEFAULTS.get(line["kernel"], {}))
    shape.update({k: v for k, v in line.items() if k not in _MEASURED})
    return json.dumps(shape, sort_keys=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--phases", default="1,2")
    ap.add_argument("--out", default="_ab/ab_chip_smoke.jsonl")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows: dict[str, dict] = {}
    with open(args.out, "w") as out:
        for turn, tree in enumerate(["parent", "change", "change", "parent"]):
            root = os.path.abspath(getattr(args, tree))
            run = subprocess.run([sys.executable, "chip_smoke.py", "--phases", args.phases],
                                 cwd=root, capture_output=True, text=True)
            if run.returncode != 0:
                print(f"{tree} (turn {turn}) failed ({run.returncode}):\n{run.stderr[-4000:]}",
                      file=sys.stderr)
                return 1
            for text in run.stdout.splitlines():
                if not text.startswith("{"):
                    continue
                line = json.loads(text)
                if "phase" not in line:
                    continue
                out.write(json.dumps({"tree": tree, "turn": turn, **line}) + "\n")
                if line["phase"] == 2:
                    if "ms" not in line or "kernel" not in line:
                        continue  # an equality-only or memory row
                    row = rows.setdefault(row_key(line), {"parent": [], "change": []})
                    row[tree].append(line["ms"])
                    row["bound_ms"] = line["bound_ms"]
                elif isinstance(line.get("runs"), list) or "seconds" in line:
                    shape = {f: line[f] for f in _CASE
                             if not isinstance(line.get(f, []), (list, dict))}
                    row = rows.setdefault(json.dumps(shape), {"parent": [], "change": []})
                    runs = line.get("runs")
                    row[tree] += ([r["seconds"] for r in runs if "seconds" in r]
                                  if isinstance(runs, list) else [line["seconds"]])
    print(json.dumps({"ab": [{"row": json.loads(k), **v} for k, v in rows.items()]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
