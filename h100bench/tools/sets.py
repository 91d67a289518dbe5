"""Runs of one cell in a row, each a process of its own as a check makes
them, with their result lines gathered; the spreads the bounds come from.

    python3 h100bench/tools/sets.py --workload <cell> --seconds <s> --seeds 11 12 13 \
        [--trace 0|1] [--out chiprun_out/<name>.jsonl]

Prints each run's result line, its check lines and its seconds, then for
each metric the median and the spread (first to third quartile over the
median, ``statistics.quantiles(values, n=4)``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    rows = []
    for seed in args.seeds:
        t0 = time.time()
        r = subprocess.run([sys.executable, "h100bench/run.py", "--workload", args.workload,
                            "--seed", str(seed), "--seconds", str(args.seconds),
                            "--trace", str(args.trace)], cwd=ROOT, capture_output=True,
                           text=True)
        took = time.time() - t0
        lines = r.stdout.strip().splitlines()
        res = json.loads(lines[-1]) if r.returncode == 0 and lines else None
        info = [ln for ln in lines[:-1] if ln.startswith("h100bench:")]
        info += [ln for ln in r.stderr.splitlines() if ln.startswith("read ")]
        print(f"seed {seed} rc {r.returncode} took {took:.1f} s", *info, sep="\n  ")
        if res is None:
            print(r.stdout[-3000:], r.stderr[-6000:])
        else:
            print("  " + json.dumps(res))
        rows.append({"seed": seed, "rc": r.returncode, "took": took, "result": res,
                     "info": info, "stderr_tail": r.stderr[-2000:]})
        sys.stdout.flush()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    ok = [r["result"] for r in rows if r["result"]]
    if len(ok) >= 2:
        for name in ok[0]["metrics"]:
            vals = [r["metrics"][name]["value"] for r in ok if name in r["metrics"]]
            sp = spread(vals) if len(vals) >= 2 else float("nan")
            print(f"{name}: median {statistics.median(vals)!r} spread {sp!r} values {vals}")
        for name in ok[0].get("checks", {}):
            vals = [r["checks"][name]["value"] for r in ok]
            print(f"check {name}: max {max(vals)!r} values {vals}")
        print("correct:", [r["correct"] for r in ok])


if __name__ == "__main__":
    main()
