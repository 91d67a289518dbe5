"""The benchmark of far_tpu_torch on an NVIDIA card: one run of one cell.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration
(``h100bench/configs/<config>.json``: the model as it is run) and has a
traffic file of its own (``h100bench/workloads/<cell>.json``: the entry
point, batch, loop, pools, the sample the check compares and its limits).
The entry (``h100bench/entries/<entry>.py``) builds the program from the
seed and drives one request at a time. This file sets up, runs the closed
loop for ``--seconds``, reads the peak memory, traces a few more requests
with ``--trace 1``, frees the program, has the plain reference judge a
sample of the window's requests, and prints one JSON line last: the
cell's end-to-end metrics (``h100bench/e2e/<metric>.py``) or, with
``--trace 1``, its per-layer metrics (``h100bench/metrics/<metric>.py``).
Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "far_tpu")


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def card_line(query: str = "name,power.limit") -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None, bench: dict = None, device: str = "cuda",
         workloads: Path = HERE / "workloads") -> int:
    """One run; ``bench``, ``device`` and ``workloads`` let the tests drive
    a tiny cell on the CPU."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()

    import torch

    from h100bench import trace as tr

    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"h100bench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"h100bench: needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    ctx = SimpleNamespace(
        config=json.loads((ROOT / config["file"]).read_text()),
        workload=json.loads((workloads / f"{args.workload}.json").read_text()),
        seed=args.seed, device=torch.device(device))
    on_card = ctx.device.type == "cuda"
    if on_card:
        print(f"h100bench: card {card_line()}; peaks {tr.PEAK_BF16:.4g} FLOP/s bf16, "
              f"{tr.PEAK_BYTES:.4g} B/s HBM", flush=True)
    entry = tr.load_module(HERE / "entries" / f"{ctx.workload['entry']}.py")
    session = entry.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    lat, pairs, failed, i = [], 0, 0, 0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        n, bad = session.request(i)
        b = time.perf_counter()
        lat.append(b - a)
        pairs += n
        failed += bad
        i += 1
        if b - t0 >= args.seconds:
            break
    window_s = b - t0
    peak = torch.cuda.max_memory_reserved(ctx.device) if on_card else 0
    view = None
    if args.trace:
        if not on_card:
            print("h100bench: --trace 1 needs the card", file=sys.stderr)
            return 3
        view = tr.record(session.request, i, ctx.workload["trace_requests"], session.shapes)
    ms = sorted(1e3 * x for x in lat)
    print(f"h100bench: {i} requests, {pairs} pairs in {window_s:.3f} s; setup {setup_s:.3f} s; "
          f"request ms mean {sum(ms) / len(ms):.3f} median {ms[len(ms) // 2]:.3f} "
          f"max {ms[-1]:.3f}; {session.stats()}", flush=True)
    if on_card:
        print(f"h100bench: after the window: clocks.sm, power.draw, temperature "
              f"{card_line('clocks.sm,power.draw,temperature.gpu')}", flush=True)

    t_check = time.perf_counter()
    try:
        numbers = session.check()
    except Exception:  # a check that cannot read the program's output fails it
        traceback.print_exc()
        numbers = {k: math.inf for k in ctx.workload["limits"]}
    print(f"h100bench: the reference's check took {time.perf_counter() - t_check:.3f} s",
          flush=True)
    limits = ctx.workload["limits"]
    correct = failed == 0 and all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
                                  for k in limits)
    found = forbidden_modules()
    if found:
        print(f"h100bench: the run loaded {found}, which the benchmark may not load",
              file=sys.stderr)
        return 4

    run = SimpleNamespace(latencies_s=lat, pairs=pairs, window_s=window_s,
                          setup_s=setup_s, peak_bytes=peak)
    metrics = {}
    kinds = ("per_layer", tr.HERE / "metrics", view) if args.trace else \
        ("end_to_end", tr.HERE / "e2e", run)
    for m in bench[kinds[0]]:
        if applies(m, args.workload):
            value = tr.load_module(kinds[1] / f"{m['name']}.py").read(kinds[2])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": i * session.batch, "failed": failed,
              "metrics": metrics, "device": dev}
    if view is not None:
        dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
        result["breakdown"] = view.breakdown()
    result["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else str(numbers[k]),
                            "limit": limits[k]} for k in limits}
    for k in numbers:
        if k not in limits:
            print(f"read {k} = {numbers[k]!r} (not compared)", file=sys.stderr)
    for k in limits:
        print(f"check {k} = {numbers[k]!r} (limit {limits[k]!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not this folder
    sys.exit(main())
