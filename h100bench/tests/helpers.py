"""A tiny FAR cell that the harness runs on the CPU."""

import json
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"
CELLS = ("far_tiny.b2",)

TINY_BENCH = {
    "configs": [{"name": "far_tiny", "file": "h100bench/tests/data/far_tiny.json"}],
    "workloads": [{"name": c, "config": c.split(".")[0], "traffic": "b2", "chips": 1}
                  for c in CELLS],
    "end_to_end": [{"name": "pairs_per_s", "unit": "pairs/s"},
                   {"name": "latency_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
    "per_layer": [],
}


def run_tiny(capsys, cell="far_tiny.b2", seed=2 ** 31 + 77, seconds=1.0):
    """One CPU run of a tiny cell -> (exit code, result line as a dict, with
    the numbers read but not compared under ``read``)."""
    from h100bench import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)],
                  bench=TINY_BENCH, device="cpu", workloads=DATA)
    cap = capsys.readouterr()
    res = json.loads(cap.out.strip().splitlines()[-1])
    res["read"] = {ln.split()[1]: float(ln.split()[3]) for ln in cap.err.splitlines()
                   if ln.startswith("read ")}
    return rc, res


def session(cell, seed):
    """The cell's entry session without the program (the control's)."""
    import torch

    from h100bench.trace import load_module

    traffic = json.loads((DATA / f"{cell}.json").read_text())
    entry = load_module(DATA.parents[1] / "entries" / f"{traffic['entry']}.py")
    ctx = type("Ctx", (), dict(config=json.loads((DATA / f"{cell.split('.')[0]}.json").read_text()),
                               workload=traffic, seed=seed, device=torch.device("cpu")))
    return entry.Session(ctx, program=False)
