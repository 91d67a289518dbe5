"""Structured metric logging.

The port's copy of ``far_tpu/utils/logging.py`` (in place of the
reference's TensorBoard SummaryWriter and rank-zero muting,
crockwell/far: mp3d_loftr/src/utils/misc.py:31-40): one JSON line of
scalars a call in ``<logdir>/<name>_metrics.jsonl``, nothing off process
0. The JAX package also writes TensorBoard events where that package
imports; the port does not (its import pulls in TensorFlow where that is
installed), so the JSONL is the one record.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import numpy as np


class MetricLogger:
    def __init__(self, logdir, name: str = "train", rank: int = 0,
                 print_every: int = 100):
        self.rank = rank
        self.print_every = print_every
        self._running = defaultdict(list)
        self._fh = None
        if rank != 0:
            return
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        self._fh = open(logdir / f"{name}_metrics.jsonl", "a")

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = "") -> None:
        if self.rank != 0:
            return
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            v = float(np.asarray(v))
            key = f"{prefix}{k}"
            rec[key] = v
            self._running[key].append(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.print_every and step % self.print_every == 0:
            means = {k: float(np.mean(v[-self.print_every:]))
                     for k, v in self._running.items()}
            msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items()))
            print(f"[step {step}] {msg}", flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
