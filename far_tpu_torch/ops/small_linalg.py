"""Batched symmetric eigensolver (n <= 9) and 3x3 SVD on the card.

Counterpart of what XLA computes on the device inside the JAX package's
jitted request for ``jnp.linalg.eigh`` (``far_tpu/geometry/solvers.py:65``,
the 8-point polish's 9x9 normal equations) and ``jnp.linalg.svd``
(``:178``, ``:209``, its rank-2 and essential projections); not a Pallas
kernel. ``torch.linalg.eigh`` and ``torch.linalg.svd`` synchronise the
card with the host on CUDA inputs (they read the solver's ``info``), so a
request that calls them cannot be captured in a CUDA graph. The kernels
of ``far_tpu_torch/csrc/small_linalg.cu`` launch on the current stream,
read nothing back and branch on nothing on the host: cyclic Jacobi with a
fixed number of sweeps in float32, on the symmetric matrix (one a warp)
and, one-sided, on the columns of the 3x3 (one a thread; the source says
how). The plain versions are ``torch.linalg.eigh`` and
``torch.linalg.svd``: the CPU runs them. ``eigh_jacobi_model`` and
``svd3_model`` write the kernels' schedule out in plain torch, as
``ops/tf32.py`` models 3xTF32, so the CPU tests can check it and choose
the sweep counts.

What the kernels match (``tests/test_torch_graph.py``; on the card
``tests/test_torch_hopper.py``; ``chip_smoke.py`` phase 3 times them):
eigenvalues ascending and eigenvectors up to sign as ``torch.linalg.eigh``
gives them; singular values descending, U and V up to a common sign per
column; the products ``(U S) Vh`` the 8-point solver forms within
1e-5 max|ref| in float32, nearly rank-1 F included.
"""

from __future__ import annotations

from typing import Tuple

import torch

from far_tpu_torch.ops import _build

# Jacobi sweeps. Cyclic Jacobi converges quadratically once the
# off-diagonal mass is small: run in float64, the model reaches float64's
# own answer after 6 sweeps on the polish's 9x9 matrices and after 4 of
# the one-sided sweeps on a 3x3 F; two more of each are kept (tests/test_torch_graph.py holds
# the model at these counts).
EIGH_SWEEPS = 8
SVD3_SWEEPS = 6
MAX_N = 9


def _copysign_one(x: torch.Tensor) -> torch.Tensor:
    return torch.copysign(torch.ones_like(x), x)


def _jacobi(a: torch.Tensor, sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's sweeps on symmetric (..., n, n) ``a`` (changed in
    place): the rotated matrix and the accumulated rotations V."""
    n = a.shape[-1]
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    others = {(p, q): [r for r in range(n) if r not in (p, q)]
              for p in range(n) for q in range(n)}
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = (a[..., i, j].clone() for i, j in ((p, p), (q, q), (p, q)))
                rot = apq != 0
                tau = (aqq - app) / (2.0 * torch.where(rot, apq, torch.ones_like(apq)))
                t = _copysign_one(tau) / (tau.abs() + torch.sqrt(tau * tau + 1.0))
                c = 1.0 / torch.sqrt(t * t + 1.0)
                s = t * c
                r = others[p, q]
                arp, arq = a[..., r, p], a[..., r, q]
                cr, sr, rr = c[..., None], s[..., None], rot[..., None]
                np_ = torch.where(rr, cr * arp - sr * arq, arp)
                nq = torch.where(rr, sr * arp + cr * arq, arq)
                a[..., r, p] = np_
                a[..., p, r] = np_
                a[..., r, q] = nq
                a[..., q, r] = nq
                a[..., p, p] = torch.where(rot, app - t * apq, app)
                a[..., q, q] = torch.where(rot, aqq + t * apq, aqq)
                zero = torch.where(rot, torch.zeros_like(apq), apq)
                a[..., p, q] = zero
                a[..., q, p] = zero
                vp, vq = v[..., :, p].clone(), v[..., :, q].clone()
                v[..., :, p] = torch.where(rr, cr * vp - sr * vq, vp)
                v[..., :, q] = torch.where(rr, sr * vp + cr * vq, vq)
    return a, v


def eigh_jacobi_model(A: torch.Tensor, sweeps: int = EIGH_SWEEPS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch model of ``far_eigh_small``: A's lower triangle
    mirrored, the kernel's row-cyclic Jacobi sweeps, eigenvalues sorted
    ascending (stable) with their eigenvectors as columns. The kernel
    fuses some products (``fmaf``) that this model rounds twice."""
    low = torch.tril(A)
    a, v = _jacobi(low + torch.tril(A, -1).transpose(-1, -2), sweeps)
    w, order = torch.sort(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1, stable=True)
    return w, torch.gather(v, -1, order[..., None, :].expand(v.shape))


def _unit(x: torch.Tensor):
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    ok = (n > 0) & torch.isfinite(n)
    return torch.where(ok, x / torch.where(ok, n, torch.ones_like(n)), x), ok


def _jacobi_columns(F: torch.Tensor, sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's one-sided Jacobi sweeps on (..., 3, 3) F: the rotated
    columns A (orthogonal to each other at convergence) and the
    accumulated rotations V, F = A V^T."""
    a = F.clone()
    v = torch.eye(3, dtype=F.dtype, device=F.device).expand(F.shape).clone()
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            ap, aq = a[..., :, p].clone(), a[..., :, q].clone()
            alpha, beta, gamma = (ap * ap).sum(-1), (aq * aq).sum(-1), (ap * aq).sum(-1)
            rot = gamma != 0
            tau = (beta - alpha) / (2.0 * torch.where(rot, gamma, torch.ones_like(gamma)))
            t = _copysign_one(tau) / (tau.abs() + torch.sqrt(tau * tau + 1.0))
            t = torch.where(rot, t, torch.zeros_like(t))
            c = (1.0 / torch.sqrt(t * t + 1.0))[..., None]
            s = t[..., None] * c
            a[..., :, p], a[..., :, q] = c * ap - s * aq, s * ap + c * aq
            vp, vq = v[..., :, p].clone(), v[..., :, q].clone()
            v[..., :, p], v[..., :, q] = c * vp - s * vq, s * vp + c * vq
    return a, v


def svd3_model(F: torch.Tensor, sweeps: int = SVD3_SWEEPS):
    """Plain-torch model of ``far_svd3`` on (..., 3, 3): one-sided Jacobi
    on F's columns (F^T F is never formed), the columns a_i and V's ordered
    by norm, descending (stable); u1 = a1 / |a1|, u2 = a2 less its u1 part,
    normalised, u3 = u1 x u2, S = (|a1|, |that remainder|, u3 . a3) with
    v3 negated where u3 . a3 < 0. Returns (U, S, Vh) as
    ``torch.linalg.svd``. The kernel fuses some products (``fmaf``) that
    this model rounds twice."""
    a, v = _jacobi_columns(F, sweeps)
    _, order = torch.sort(torch.linalg.norm(a, dim=-2), dim=-1, descending=True, stable=True)
    idx = order[..., None, :].expand(F.shape)
    a, V = torch.gather(a, -1, idx), torch.gather(v, -1, idx)
    a1, a2, a3 = a[..., :, 0], a[..., :, 1], a[..., :, 2]
    u1, ok1 = _unit(a1)
    e0 = torch.zeros_like(u1)
    e0[..., 0] = 1.0
    u1 = torch.where(ok1, u1, e0)
    w2 = a2 - (u1 * a2).sum(-1, keepdim=True) * u1
    u2, ok2 = _unit(w2)
    axis = torch.nn.functional.one_hot(u1.abs().argmin(-1), 3).to(F.dtype)
    fallback, _ = _unit(axis - (u1 * axis).sum(-1, keepdim=True) * u1)
    u2 = torch.where(ok2, u2, fallback)
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    s3 = (u3 * a3).sum(-1)
    flip = torch.where(s3 < 0, -torch.ones_like(s3), torch.ones_like(s3))
    S = torch.stack([torch.linalg.norm(a1, dim=-1), torch.linalg.norm(w2, dim=-1),
                     s3 * flip], -1)
    V = torch.cat([V[..., :, :2], V[..., :, 2:] * flip[..., None, None]], -1)
    return torch.stack([u1, u2, u3], -1), S, V.transpose(-1, -2)


def _check(x: torch.Tensor, what: str) -> None:
    _build.require(x.dtype == torch.float32,
                   f"{what} takes float32 on the card, got {x.dtype}")


def eigh_small(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending) and eigenvectors (columns) of symmetric
    (..., n, n), n <= 9, read from the lower triangle: ``torch.linalg.eigh``
    on the CPU, ``far_eigh_small`` on CUDA."""
    if _build.on_cpu(A):
        return torch.linalg.eigh(A)
    n = A.shape[-1]
    _check(A, "eigh_small")
    _build.require(A.ndim >= 2 and A.shape[-2] == n and 1 <= n <= MAX_N,
                   f"eigh_small takes (..., n, n) with n <= {MAX_N}, got {tuple(A.shape)}")
    lead = A.shape[:-2]
    flat = A.reshape(-1, n, n).contiguous()
    batch = flat.shape[0]
    w = torch.empty((batch, n), dtype=A.dtype, device=A.device)
    V = torch.empty((batch, n, n), dtype=A.dtype, device=A.device)
    if batch:
        fn = _build.bind("small_linalg", "far_eigh_small", 3, 3)
        _build.check(fn(flat.data_ptr(), w.data_ptr(), V.data_ptr(), batch, n,
                        EIGH_SWEEPS, _build.stream_of(A)), "eigh_small")
        _build.count_launch(eigh_small)
    return w.reshape(*lead, n), V.reshape(*lead, n, n)


def svd3(F: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, S, Vh) of (..., 3, 3), S descending: ``torch.linalg.svd`` on the
    CPU, ``far_svd3`` on CUDA."""
    if _build.on_cpu(F):
        return torch.linalg.svd(F)
    _check(F, "svd3")
    _build.require(F.ndim >= 2 and tuple(F.shape[-2:]) == (3, 3),
                   f"svd3 takes (..., 3, 3), got {tuple(F.shape)}")
    lead = F.shape[:-2]
    flat = F.reshape(-1, 3, 3).contiguous()
    batch = flat.shape[0]
    U = torch.empty_like(flat)
    S = torch.empty((batch, 3), dtype=F.dtype, device=F.device)
    Vh = torch.empty_like(flat)
    if batch:
        fn = _build.bind("small_linalg", "far_svd3", 4, 2)
        _build.check(fn(flat.data_ptr(), U.data_ptr(), S.data_ptr(), Vh.data_ptr(), batch,
                        SVD3_SWEEPS, _build.stream_of(F)), "svd3")
        _build.count_launch(svd3)
    return U.reshape(*lead, 3, 3), S.reshape(*lead, 3), Vh.reshape(*lead, 3, 3)


eigh_small.launches = 0  # launches of far_eigh_small
svd3.launches = 0        # launches of far_svd3
