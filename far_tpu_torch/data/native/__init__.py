"""ctypes bindings of the native preprocessing library (``preprocess.cpp``).

The port's counterpart of ``far_tpu/data/native``. The library is built
at first use, never at import, with ``g++ -O3 -fopenmp -shared -fPIC``
into ``far_tpu_torch/build/`` (listed in ``.gitignore``), named by a hash
of its source and flags so an edited source is rebuilt. There is no
fallback: a build or load failure raises with the compiler command and
its output, since any other resize (PIL's antialiased bilinear, numpy)
gives other pixels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from far_tpu_torch.ops._build import BUILD

SRC = Path(__file__).resolve().parent / "preprocess.cpp"
CXX = ("g++", "-O3", "-fopenmp", "-shared", "-fPIC")

_LIB = None


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX).encode())
    return BUILD / f"libfar_preprocess_{h.hexdigest()[:12]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*CXX, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native preprocess build failed: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native preprocess build failed: {' '.join(cmd)} exited "
                           f"{res.returncode}:\n{res.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built first if it is not in the build directory."""
    global _LIB
    if _LIB is None:
        path = lib_path()
        if not path.exists():
            _compile(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            # a RuntimeError, so a dataset's skip-unreadable retry (which
            # catches OSError) does not take it for a bad file
            raise RuntimeError(f"native preprocess library {path} failed to load: {e}") from e
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.far_resize_bilinear_u8.argtypes = [u8p, u8p] + [ctypes.c_int] * 6
        lib.far_resize_bilinear_u8.restype = None
        _LIB = lib
    return _LIB


def resize_bilinear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize (half-pixel centres, no antialiasing) of (H, W[, C])
    or (N, H, W, C) uint8 images."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bilinear_u8 takes uint8, got {img.dtype}")
    if not (0 < out_h and 0 < out_w):
        raise ValueError(f"output size {out_h}x{out_w}")
    lib = load()
    squeeze_c = img.ndim == 2
    if squeeze_c:
        img = img[..., None]
    squeeze_n = img.ndim == 3
    if squeeze_n:
        img = img[None]
    img = np.ascontiguousarray(img)
    n, h, w, c = img.shape
    out = np.empty((n, out_h, out_w, c), np.uint8)
    lib.far_resize_bilinear_u8(img, out, n, h, w, c, out_h, out_w)
    if squeeze_n:
        out = out[0]
    if squeeze_c:
        out = out[..., 0]
    return out
