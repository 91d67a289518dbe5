"""The traced part of a run and what the per-layer readers take from it.

``record`` traces a few requests with ``torch.profiler`` (host and
device), each inside a host range named ``h100bench.request``. A
``View`` holds the device operations of each request, in launch order, as
(symbol, start us, duration us), with the kernel tables
(``h100bench/kernels/<kernel>.py``) and the cell's shapes, and gives the
arithmetic the readers share: busy time as the union of device
intervals, a kernel's device time and roofline share, the operations
after a kernel's last launch. A CUDA graph's replay shows its kernels in
the trace like eager launches, in capture order, so the program's own
kernels serve as landmarks between stages.
"""

from __future__ import annotations

import importlib.util
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

HERE = Path(__file__).resolve().parent
REQUEST = "h100bench.request"

# H100 SXM, NVIDIA's data sheet, dense: bf16 tensor cores and HBM3
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

Op = Tuple[str, float, float]  # (symbol, start us, duration us)
COPIES = ("Memcpy", "Memset")  # device operations that are not kernels


def load_module(path: Path):
    """A harness file imported by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "h100bench_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_tables() -> Dict[str, object]:
    """Every kernel file, by its name."""
    return {p.stem: load_module(p) for p in sorted((HERE / "kernels").glob("*.py"))}


def symbol(name: str) -> str:
    """A device kernel's demangled name as the kernel files key it: its
    innermost namespace (anon for an anonymous one) and its name, without
    return type, template arguments or parameters."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)", "anon"), maxsplit=1)[0]
    words = head.split()
    return "::".join(words[-1].split("::")[-2:]) if words else name


def union_us(spans: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class View:
    def __init__(self, requests: List[List[Op]], host: List[Tuple[str, float, float]],
                 spans: List[Tuple[float, float]], shapes: dict):
        self.requests = requests      # device ops of each traced request
        self.host = host              # (name, start us, end us) of host operations
        self.spans = spans            # host range of each traced request
        self.shapes = shapes
        self.kernels = kernel_tables()
        self.window_s = (spans[-1][1] - spans[0][0]) / 1e6
        ops = [o for r in requests for o in r]
        self.busy_s = union_us([(s, s + d) for _, s, d in ops]) / 1e6

    # ---- shared arithmetic of the readers ----
    def names_of(self, kernel: str) -> set:
        return set(self.kernels[kernel].SYMBOLS)

    def kernel_ms(self, kernel: str) -> Optional[float]:
        """Device ms a request in ``kernel``'s functions; None where no
        traced request launched one."""
        names = self.names_of(kernel)
        per = [sum(d for n, _, d in r if n in names) for r in self.requests]
        return None if not any(per) else sum(per) / len(per) / 1e3

    def roofline(self, kernel: str) -> Optional[float]:
        """The kernel's least time at the card's peaks over its measured
        device time, in % (None where it did not run)."""
        ms = self.kernel_ms(kernel)
        if ms is None:
            return None
        mod = self.kernels[kernel]
        flops, nbytes = mod.work(self.shapes)
        peak = getattr(mod, "PEAK", PEAK_BF16)
        return 100.0 * max(flops / peak, nbytes / PEAK_BYTES) * 1e3 / ms

    def after_last(self, kernel: str) -> Optional[List[List[Op]]]:
        """Each request's device ops after its last launch of ``kernel``."""
        names = self.names_of(kernel)
        out = []
        for r in self.requests:
            idx = [i for i, (n, _, _) in enumerate(r) if n in names]
            if not idx:
                return None
            out.append(r[idx[-1] + 1:])
        return out

    def before_first(self, kernel: str) -> Optional[List[List[Op]]]:
        """Each request's device ops before its first launch of ``kernel``."""
        names = self.names_of(kernel)
        out = []
        for r in self.requests:
            idx = [i for i, (n, _, _) in enumerate(r) if n in names]
            if not idx:
                return None
            out.append(r[:idx[0]])
        return out

    def busy_ms_each(self, parts: List[List[Op]]) -> float:
        """Mean busy ms of a list of per-request op lists."""
        return sum(union_us([(s, s + d) for _, s, d in p]) for p in parts) / len(parts) / 1e3

    def request_s(self) -> float:
        """Mean host time of a traced request."""
        return sum(e - s for s, e in self.spans) / len(self.spans) / 1e6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the host
        activity during the ten longest idle gaps (gaps named by the
        innermost host operation open at their start)."""
        tot: Dict[str, float] = {}
        ops = sorted((s, s + d, n) for r in self.requests for n, s, d in r)
        for s, e, n in ops:
            tot[n] = tot.get(n, 0.0) + (e - s) / 1e6
        device_ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        cur_e = ops[0][1] if ops else 0.0
        for s, e, _ in ops[1:]:
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_e = max(cur_e, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda h: h[2] - h[1])
        idle = []
        for gs, ge in gaps[:10]:
            name = next((n for n, hs, he in host if hs <= gs < he), "host idle")
            idle.append([name, (ge - gs) / 1e6])
        return {"device_ops": [[n, v] for n, v in device_ops], "idle_gaps": idle}


def record(request, first: int, n: int, shapes: dict) -> View:
    """Trace requests first .. first + n - 1 (``request(i)`` runs one and
    waits for its result) and read the trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for i in range(first, first + n):
            with torch.profiler.record_function(REQUEST):
                request(i)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = prof.events()
    dev, host, spans = [], [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name == REQUEST:  # the host range's mirror on the device's timeline
                continue
            name = e.name if e.name.startswith(COPIES) else symbol(e.name)
            dev.append((e.time_range.start, e.time_range.elapsed_us(), name))
        elif e.name == REQUEST:
            spans.append((e.time_range.start, e.time_range.end))
        else:
            host.append((e.name, e.time_range.start, e.time_range.end))
    spans.sort()
    dev.sort()
    requests: List[List[Op]] = [[] for _ in spans]
    k = 0
    for s, d, name in dev:
        while k + 1 < len(spans) and s >= spans[k + 1][0]:
            k += 1
        if spans[k][0] <= s < spans[k][1]:
            requests[k].append((name, s, d))
    print(f"h100bench: trace read in {time.perf_counter() - t0:.1f} s: {len(dev)} device "
          f"ops over {len(spans)} requests", flush=True)
    return View(requests, host, spans, shapes)
