"""Communication across the processes of a data-parallel run.

The port's counterpart of ``far_tpu/parallel/comm.py``. The JAX package
runs one jitted step over a device mesh and lets XLA insert the
reductions; the port runs one process per card under
``torch.distributed`` (started by ``python -m torch.distributed.run``),
DDP reduces the gradients, and what else crosses ranks goes through
here:

- ``init_distributed`` joins the process group: NCCL when the run is on
  CUDA, gloo on the CPU; ``local_device`` is this rank's device;
- ``all_reduce_sum``: a sum over ranks that autograd differentiates (its
  backward sums the gradients over ranks), for BatchNorm's moments;
  ``mean_over_ranks`` and ``mean_scalars`` for values without gradient;
- ``all_gather_metrics``: fixed-shape numpy arrays gathered to every
  rank, concatenated on axis 0 in rank order, as
  ``multihost_utils.process_allgather`` does; identifier strings ride it
  as a fixed-width byte matrix (``encode_strings``, ``decode_strings``);
- ``shard_rows``: this rank's contiguous rows of a global batch, as the
  JAX package's ``P("data")`` places them;
- ``data_parallel``: a module wrapped in DDP under a process group;
- ``barrier``.

Without a process group every function is the identity of one process.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialised() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialised() else 1


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> None:
    """Join the process group of a data-parallel run.

    The world comes from the arguments (``coordinator_address`` as
    ``host:port``, ``num_processes``, ``process_id``, as the JAX
    package's function takes them) or else from the environment that
    ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``). With neither, or
    with a group already joined, it does nothing. A launcher's world of
    one still gets its group, so ``--nproc_per_node 1`` runs the NCCL path.

    ``device`` is the run's: on CUDA the backend is NCCL and the card is
    ``cuda:LOCAL_RANK`` (``torch.cuda.set_device`` before any model is
    built, so ``"cuda"`` means this rank's card); on the CPU it is gloo.
    A failed NCCL initialisation raises: nothing falls back to gloo.
    """
    if _initialised():
        return
    if num_processes is None and "WORLD_SIZE" not in os.environ:
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a gloo run")
        local_rank = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local_rank) if local_rank is not None
                              else (process_id or 0) % torch.cuda.device_count())
    kw = dict(backend="nccl" if dev.type == "cuda" else "gloo")
    if num_processes is None:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, **kw)


def group_summary() -> Optional[str]:
    """``data parallel: W processes, <backend>`` under a process group."""
    if not _initialised():
        return None
    w = process_count()
    return f"data parallel: {w} process{'es' if w > 1 else ''}, {dist.get_backend()}"


def local_device(device="cuda") -> torch.device:
    """This rank's device of ``device``'s type: ``cuda`` names the card
    ``init_distributed`` set (``cuda:LOCAL_RANK``; ``cuda:0`` in one
    process), anything else is returned as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def barrier() -> None:
    if not _initialised():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the gradient of each rank's input is the sum over
    ranks of the output's gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ranks, differentiably; ``x`` itself in one process."""
    return _AllReduceSum.apply(x) if process_count() > 1 else x


@torch.no_grad()
def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of ``x``, without gradient; ``x`` in one process."""
    w = process_count()
    return x.detach() if w == 1 else all_reduce_sum(x.detach()) / w


def mean_scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar tensors as floats, each the mean over ranks of the ranks'
    values (one all-reduce, in float64). A step's losses are each rank's
    share of the global batch's, so the mean is the global value."""
    keys = list(metrics)
    vals = mean_over_ranks(torch.stack([metrics[k].detach().to(torch.float64)
                                        for k in keys]))
    return dict(zip(keys, vals.tolist()))


def shard_rows(x, n: Optional[int] = None):
    """This rank's contiguous rows of ``x`` (a tensor, or a dataclass or
    list of them, None left as it is): rank r of W keeps rows
    [r n / W, (r + 1) n / W) of axis 0, ``n`` the rows of the first tensor.
    Raises unless W divides n, as a sharded ``device_put`` does."""
    w = process_count()
    if w == 1 or x is None:
        return x
    if dataclasses.is_dataclass(x):
        fields = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
        n = n or next(v for v in fields.values() if isinstance(v, torch.Tensor)).shape[0]
        return dataclasses.replace(x, **{k: shard_rows(v, n) if isinstance(v, torch.Tensor)
                                         else v for k, v in fields.items()})
    if isinstance(x, (list, tuple)):
        return type(x)(shard_rows(v, n) for v in x)
    n = x.shape[0] if n is None else n
    if x.shape[0] != n or n % w:
        raise ValueError(f"a global batch of {x.shape[0]} rows does not split over "
                         f"{w} processes")
    b = n // w
    return x[process_index() * b:(process_index() + 1) * b]


def data_parallel(module: torch.nn.Module, find_unused_parameters: bool = False):
    """``module`` wrapped in DDP under a process group (any world size),
    else ``module``. The buffers are not broadcast at each forward: the
    port's BatchNorm keeps its running statistics equal on every rank."""
    if not _initialised():
        return module
    from torch.nn.parallel import DistributedDataParallel

    dev = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=find_unused_parameters)


def encode_strings(strings, width: int = 96) -> np.ndarray:
    """(N, width) uint8: each string's utf-8 bytes, cut at ``width`` and
    padded with zeros."""
    out = np.zeros((len(strings), width), np.uint8)
    for i, s in enumerate(strings):
        b = s.encode("utf-8")[:width]
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out


def decode_strings(mat: np.ndarray) -> list:
    return [bytes(row[row != 0]).decode("utf-8", "replace") for row in mat]


def all_gather_metrics(metrics: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every process's metric arrays, joined on axis 0 in rank order (a
    0-d array gives one row a rank); in one process the input itself.

    The arrays must have the same shape on every rank: the padded
    ``sequential_indices`` gives every rank as many pairs, and the
    aggregation drops the repeats by identifier. The tensors go on the
    backend's device: this rank's card under NCCL, the CPU under gloo.
    """
    w = process_count()
    if w == 1:
        return metrics
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    out = {}
    for k, v in metrics.items():
        a = np.array(v)
        mine = torch.from_numpy(a.reshape((-1,) + a.shape[1:])).to(dev)
        parts = [torch.empty_like(mine) for _ in range(w)]
        dist.all_gather(parts, mine)
        out[k] = torch.cat(parts).cpu().numpy()
    return out
