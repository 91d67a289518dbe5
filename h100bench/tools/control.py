"""The control of a cell: the plain reference computed through fp8 in the
program's place, on the requests a run would judge, judged as a run
judges the program. The program is not built.

    python3 h100bench/tools/control.py --workload <cell> --seeds 1 2 3 [--out <file>]

Prints each seed's numbers; a limit lies below the least of them.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]


def main():
    sys.path[0] = str(ROOT)
    import torch

    from h100bench.trace import load_module

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None, help="a file the lines are appended to")
    args = p.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    wl = json.loads((ROOT / "h100bench/workloads" / f"{args.workload}.json").read_text())
    entry = load_module(ROOT / "h100bench/entries" / f"{wl['entry']}.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        ctx = SimpleNamespace(config=json.loads((ROOT / cfg["file"]).read_text()),
                              workload=wl, seed=seed, device=torch.device("cuda"))
        s = entry.Session(ctx, program=False)
        line = json.dumps({"cell": args.workload, "seed": seed,
                           "control": s.control(random.Random(seed))})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
