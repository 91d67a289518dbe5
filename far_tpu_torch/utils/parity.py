"""Golden-fixture helpers, numpy only.

The port's own copy of ``far_tpu/utils/parity.py``'s ``sd_spec_of``,
``synth_state_dict`` and ``load_fixture``, so that the golden fixtures
under ``tests/golden/`` replay without the JAX package (``chip_smoke.py``
replays them on the card). A fixture stores its state dict only as a
shape spec (``meta["sd_spec"]``); ``synth_state_dict`` rebuilds the same
arrays on any machine. ``tap_tolerance`` is the gate of
``tests/test_golden_parity.py``: taps are stored as float16.
"""

from __future__ import annotations

import json
import zlib
from typing import Dict

import numpy as np

ATOL = 1e-3      # absolute floor of every tap's gate
RTOL_MAX = 1e-3  # f16 tap rounding is ~4.9e-4 * max|tap|

# per-tap floors of far_tpu/utils/parity.py's tap tables: ViTEss's final
# LayerNorm rows have near-zero variance (torch's own f32-vs-f64 drift
# ~5e-4); mkpts1_f is in pixels
TAP_ATOL = {
    "vitess": {"features": 2e-3},
    "sixdreg": {},
    "farloftr": {"mkpts1_f": 2e-3},
}


def sd_spec_of(sd: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """Shape/dtype spec of a state dict."""
    return {k: {"shape": list(np.asarray(v).shape),
                "dtype": str(np.asarray(v).dtype)}
            for k, v in sd.items()}


def synth_state_dict(spec: Dict[str, Dict], seed: int = 0
                     ) -> Dict[str, np.ndarray]:
    """A torch-layout state dict from a shape spec, the same arrays on any
    machine (scheme v1 of the JAX package): per key a numpy stream seeded
    by (seed, crc32(key)); float ndim >= 2: normal * sqrt(2 / fan_in);
    1-D ``running_var``/``*_var``: |1 + 0.1 normal|; other 1-D floats:
    0.05 normal, plus 1 for keys ending in ``weight``; integers: zeros.
    A key with ``alias_of`` (one storage under two names, as a module
    registered twice) copies its canonical key's array."""
    out = {}
    for k in sorted(spec):
        if spec[k].get("alias_of"):
            continue
        shape = tuple(spec[k]["shape"])
        dtype = np.dtype(spec[k]["dtype"])
        rng = np.random.default_rng([seed, zlib.crc32(k.encode())])
        if not np.issubdtype(dtype, np.floating):
            out[k] = np.zeros(shape, dtype)
            continue
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[1:]))
            arr = rng.standard_normal(shape) * np.sqrt(2.0 / max(1, fan_in))
        elif "running_var" in k or k.endswith("_var"):
            arr = np.abs(1.0 + 0.1 * rng.standard_normal(shape))
        else:
            arr = 0.05 * rng.standard_normal(shape)
            if k.endswith("weight"):
                arr = arr + 1.0
        out[k] = arr.astype(dtype)
    for k in spec:
        src = spec[k].get("alias_of")
        if src:
            out[k] = out[src]
    return out


def load_fixture(path):
    """(meta, inputs, sd, taps) of a fixture ``.npz``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        pick = lambda p: {k[len(p):]: z[k] for k in z.files if k.startswith(p)}
        return meta, pick("input."), pick("sd."), pick("tap.")


def tap_tolerance(family: str, name: str, tap: np.ndarray) -> float:
    """max(1e-3, the tap's own floor, 1e-3 max|tap|)."""
    return max(ATOL, TAP_ATOL[family].get(name, 0.0),
               RTOL_MAX * float(np.max(np.abs(tap))))
