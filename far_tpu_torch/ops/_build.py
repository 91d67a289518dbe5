"""Build the CUDA kernels of ``far_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into its own shared library under
``far_tpu_torch/build/`` (listed in ``.gitignore``) at first use, and
loaded with ``ctypes``. The file name carries a hash of the sources, so
an edited kernel is rebuilt and a stale library is never loaded.
``build_all`` starts one ``nvcc`` per source at once, for callers that
want every kernel ready before they time anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
KERNELS = ("loftr_layer", "matching_kernel", "fine_layer",
           "bilinear_attention", "small_linalg", "stage_mark", "fivepoint")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}_{h.hexdigest()[:12]}.so"


def _compile_cmd(name: str, out: Path):
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library, all ``nvcc`` runs started together.

    Returns {name: library path}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: str(_lib_path(name)) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def bind(name: str, fn: str, n_ptr: int, n_int: int, n_float: int = 0):
    """A C entry point ``int fn(ptr x n_ptr, int x n_int, float x n_float,
    stream)`` with its ctypes signature declared."""
    f = getattr(load(name), fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def bind_size(name: str, fn: str, n_int: int):
    """A C entry point ``size_t fn(int x n_int)`` (scratch-size queries)."""
    f = getattr(load(name), fn)
    f.argtypes = [ctypes.c_int] * n_int
    f.restype = ctypes.c_size_t
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def count_launch(wrapper, route: str = "") -> None:
    """One more launch on ``wrapper``'s counters (``launches``, and
    ``launches_tc`` / ``launches_tf32`` for those routes), where its kernel
    runs now: not while the current stream captures a CUDA graph, which
    records the kernel for its replays to run without the wrapper."""
    if torch.cuda.is_current_stream_capturing():
        return
    wrapper.launches += 1
    if route in ("tc", "tf32"):
        name = "launches_" + route
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every input lies on the CPU (the wrapper then runs the
    plain version); False when all lie on one CUDA device (it launches the
    kernel). Anything else raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"inputs must all lie on the CPU or on one CUDA "
                     f"device, got {sorted(map(str, devices))}")


def refuse_grad(what: str, tensors: Iterable[torch.Tensor]) -> None:
    """A kernel's output has no ``grad_fn``: in grad mode, an input that
    requires grad raises here instead of losing its gradient silently.
    ``<what>_auto`` is the differentiable form (it calls the wrapper from
    its ``forward``, where grad mode is off)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no gradient and an input requires "
            f"grad; call {what}_auto, or run under torch.no_grad()")


def dtype_code(t: torch.Tensor) -> int:
    """0 for float32, 1 for bfloat16: the storage types the kernels take."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def scratch(nbytes: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(max(int(nbytes), 1), dtype=torch.uint8,
                       device=like.device)
