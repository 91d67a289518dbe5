"""Stage marks: a one-thread kernel that writes the card's clock into a slot.

Not a port of a TPU kernel (``csrc/stage_mark.cu`` says why it exists).
``utils/prof.py``'s ``MarkSink`` launches one at each stage boundary of
the compiled request while a capture or its warm-up runs, so the graph
holds a node at each boundary; a replay then writes each boundary's time
(ns, ``%globaltimer``) into its slot, and a profiler trace shows each mark
as a kernel named ``SYMBOL`` (the harness's ``h100bench/spans.py`` reads
them). While the stream is being captured the launch also returns the
operation nodes (kernels, copies, memsets) the capturing graph holds
before the mark. The plain version
writes the host's clock (``time.perf_counter_ns``) into the slot.
"""

from __future__ import annotations

import ctypes
import time

import torch

from far_tpu_torch.ops import _build

# the kernel's name in a trace, as h100bench/trace.py's ``symbol`` gives it
SYMBOL = "anon::stage_mark_kernel"


def stage_mark_plain(slots: torch.Tensor, k: int) -> int:
    """The host's clock (ns) into ``slots[k]``; -1 (nothing captured)."""
    slots[k] = time.perf_counter_ns()
    return -1


def stage_mark(slots: torch.Tensor, k: int) -> int:
    """Write the clock (ns) into ``slots[k]`` (int64) when the current
    stream reaches this point. Returns the operation nodes (kernels,
    copies, memsets) the graph that the stream is capturing holds before
    this mark, or -1 when the stream is not capturing."""
    _build.require(slots.dtype == torch.int64 and slots.dim() == 1 and slots.is_contiguous()
                   and 0 <= k < slots.shape[0],
                   f"stage_mark takes a contiguous int64 vector of more than {k} slots, "
                   f"got {slots.dtype} {tuple(slots.shape)}")
    if _build.on_cpu(slots):
        return stage_mark_plain(slots, k)
    fn = _build.load("stage_mark").far_stage_mark
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nodes = ctypes.c_longlong(-1)
    _build.check(fn(slots.data_ptr(), k, ctypes.byref(nodes), _build.stream_of(slots)),
                 "stage_mark")
    _build.count_launch(stage_mark)
    return nodes.value


stage_mark.launches = 0  # launches of stage_mark_kernel outside a capture
