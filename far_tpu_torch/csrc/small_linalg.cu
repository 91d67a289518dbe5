// Batched small symmetric eigensolver (one matrix a warp) and 3x3 SVD (one a thread).
//
// Counterpart of what XLA computes on the device inside the JAX package's
// jitted request for jnp.linalg.eigh (far_tpu/geometry/solvers.py:65, the
// 9x9 normal equations of the 8-point polish) and jnp.linalg.svd (:178,
// :209, its rank-2 and essential projections). It is not a Pallas kernel.
// torch.linalg.eigh and torch.linalg.svd read the solver's info back to
// the host on CUDA inputs, so a request that calls them cannot be
// captured in a CUDA graph; these kernels read nothing back and branch on
// nothing on the host.
//
// far_eigh_small: A (batch, n, n) float32, n <= 9, read from its lower
// triangle as torch.linalg.eigh reads it. Cyclic Jacobi in float32 with a
// fixed number of sweeps (row-cyclic pair order (0,1), (0,2), ..., (n-2,
// n-1)): the matrix and the accumulated rotations V sit in shared memory,
// lane r of the warp owns row r, and the rotation of pair (p, q) uses the
// symmetric Schur step t = sign(tau) / (|tau| + sqrt(1 + tau^2)), tau =
// (a_qq - a_pp) / (2 a_pq), with a_pp -= t a_pq, a_qq += t a_pq and a_pq
// set to 0; a pair with a_pq == 0 is left as it is. The eigenvalues are
// then sorted ascending (a stable insertion sort by lane 0) and written
// with the columns of V in that order. ops/small_linalg.py:
// eigh_jacobi_model is this schedule in plain torch.
//
// far_svd3: F (batch, 3, 3) float32 -> U, S (descending), Vh, one matrix
// a thread. One-sided Jacobi on F itself (F^T F is never formed: forming
// it squares the condition, and v2, v3 of a nearly rank-1 F would lose
// accuracy as u / (s2 / s1)^2): a fixed number of sweeps over the column
// pairs (0,1), (0,2), (1,2), each rotating columns p, q of A (= F at the
// start) and of V (= I) by the Schur step of their Gram entries alpha =
// |a_p|^2, beta = |a_q|^2, gamma = a_p . a_q (tau = (beta - alpha) /
// (2 gamma), t = sign(tau) / (|tau| + sqrt(1 + tau^2)), c = 1 / sqrt(1 +
// t^2), s = t c; a pair with gamma == 0 is left as it is),
// which makes a_p and a_q orthogonal. The columns are then ordered by
// norm, descending (stable), with V's; u1 = a1 / |a1|, u2 = a2 with its u1
// part removed, normalised, u3 = u1 x u2, and S = (|a1|, |a2 - (u1.a2)
// u1|, u3 . a3) with v3 negated where u3 . a3 < 0, so F = U diag(S) Vh. A
// zero column (rank below 2) gets a unit vector orthogonal to the others.
// ops/small_linalg.py: svd3_model is this schedule in plain torch.
//
// Bound: bytes and launch latency. At the polish's shapes (B = 4 pairs a
// round) a call moves a few KB and does ~10^5 flops; what it buys is that
// the request has no host synchronisation in it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NMAX = 9;
constexpr int WARPS = 4;  // matrices a block, one warp each

struct WarpMats {
  float a[NMAX * NMAX];
  float v[NMAX * NMAX];
  int order[NMAX];
};

// c x - s y and s x + c y with one rounding pattern, so lane r's (r, p) and
// (p, r) entries stay bit-equal.
__device__ __forceinline__ float rot_lo(float c, float s, float x, float y) {
  return fmaf(c, x, -__fmul_rn(s, y));
}
__device__ __forceinline__ float rot_hi(float c, float s, float x, float y) {
  return fmaf(s, x, __fmul_rn(c, y));
}

// Cyclic Jacobi on the symmetric n x n matrix m->a, accumulating the
// rotations into m->v (set to the identity here). Lanes r < n own row r.
__device__ void jacobi(WarpMats* m, int n, int sweeps, int lane) {
  if (lane < n)
    for (int c = 0; c < n; ++c) m->v[lane * NMAX + c] = lane == c ? 1.f : 0.f;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        __syncwarp();
        const float app = m->a[p * NMAX + p];
        const float aqq = m->a[q * NMAX + q];
        const float apq = m->a[p * NMAX + q];
        __syncwarp();
        if (apq == 0.f) continue;  // the same value in every lane
        const float tau = (aqq - app) / (2.f * apq);
        const float t = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(fmaf(tau, tau, 1.f)));
        const float c = 1.f / sqrtf(fmaf(t, t, 1.f));
        const float s = t * c;
        if (lane < n) {
          const int r = lane;
          if (r == p) {
            m->a[p * NMAX + p] = fmaf(-t, apq, app);
            m->a[p * NMAX + q] = 0.f;
            m->a[q * NMAX + p] = 0.f;
          } else if (r == q) {
            m->a[q * NMAX + q] = fmaf(t, apq, aqq);
          } else {
            const float arp = m->a[r * NMAX + p], arq = m->a[r * NMAX + q];
            const float np = rot_lo(c, s, arp, arq), nq = rot_hi(c, s, arp, arq);
            m->a[r * NMAX + p] = np;
            m->a[p * NMAX + r] = np;
            m->a[r * NMAX + q] = nq;
            m->a[q * NMAX + r] = nq;
          }
          const float vrp = m->v[r * NMAX + p], vrq = m->v[r * NMAX + q];
          m->v[r * NMAX + p] = rot_lo(c, s, vrp, vrq);
          m->v[r * NMAX + q] = rot_hi(c, s, vrp, vrq);
        }
      }
    }
  }
  __syncwarp();
  if (lane == 0) {  // ascending, stable; NaN compares false and stays put
    for (int k = 0; k < n; ++k) m->order[k] = k;
    for (int k = 1; k < n; ++k) {
      const int idx = m->order[k];
      const float key = m->a[idx * NMAX + idx];
      int j = k - 1;
      while (j >= 0 && m->a[m->order[j] * NMAX + m->order[j]] > key) {
        m->order[j + 1] = m->order[j];
        --j;
      }
      m->order[j + 1] = idx;
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * WARPS)
    eigh_kernel(const float* __restrict__ A, float* __restrict__ w, float* __restrict__ V,
                int batch, int n, int sweeps) {
  __shared__ WarpMats mats[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * WARPS + warp;
  if (b >= batch) return;  // the whole warp
  WarpMats* m = &mats[warp];
  const float* Ab = A + b * n * n;
  if (lane < n)
    for (int c = 0; c < n; ++c)  // the lower triangle, mirrored
      m->a[lane * NMAX + c] = lane >= c ? Ab[lane * n + c] : Ab[c * n + lane];
  jacobi(m, n, sweeps, lane);
  if (lane < n) {
    const int k = m->order[lane];
    w[b * n + lane] = m->a[k * NMAX + k];
    for (int c = 0; c < n; ++c) V[b * n * n + lane * n + c] = m->v[lane * NMAX + m->order[c]];
  }
}

__device__ __forceinline__ float dot3(const float* x, const float* y) {
  return fmaf(x[0], y[0], fmaf(x[1], y[1], x[2] * y[2]));
}

__device__ __forceinline__ float norm3(const float* x) { return sqrtf(dot3(x, x)); }

// x / |x| into out; false (out untouched) where |x| is 0 or not finite.
__device__ __forceinline__ bool unit3(const float* x, float* out) {
  const float l = norm3(x);
  if (!(l > 0.f) || !isfinite(l)) return false;
  for (int i = 0; i < 3; ++i) out[i] = x[i] / l;
  return true;
}

// A unit vector orthogonal to the unit vector u: the axis u has least of,
// with its u part removed.
__device__ void orthogonal_unit(const float* u, float* out) {
  int k = 0;
  for (int i = 1; i < 3; ++i)
    if (fabsf(u[i]) < fabsf(u[k])) k = i;
  float e[3] = {0.f, 0.f, 0.f};
  e[k] = 1.f;
  const float d = u[k];
  for (int i = 0; i < 3; ++i) e[i] -= d * u[i];
  unit3(e, out);
}

__device__ __forceinline__ void cross3(const float* x, const float* y, float* out) {
  out[0] = x[1] * y[2] - x[2] * y[1];
  out[1] = x[2] * y[0] - x[0] * y[2];
  out[2] = x[0] * y[1] - x[1] * y[0];
}

// Rotate columns p, q of the row-major 3x3 x by (c, s).
__device__ __forceinline__ void rotate_columns(float* x, int p, int q, float c, float s) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float xp = x[r * 3 + p], xq = x[r * 3 + q];
    x[r * 3 + p] = rot_lo(c, s, xp, xq);
    x[r * 3 + q] = rot_hi(c, s, xp, xq);
  }
}

// The dot product of columns p and q of the row-major 3x3 x.
__device__ __forceinline__ float column_dot(const float* x, int p, int q) {
  return fmaf(x[6 + p], x[6 + q], fmaf(x[3 + p], x[3 + q], x[p] * x[q]));
}

constexpr int SVD_THREADS = 128;  // matrices a block, one a thread

__global__ void __launch_bounds__(SVD_THREADS)
    svd3_kernel(const float* __restrict__ F, float* __restrict__ U, float* __restrict__ S,
                float* __restrict__ Vh, int batch, int sweeps) {
  const long long b = (long long)blockIdx.x * SVD_THREADS + threadIdx.x;
  if (b >= batch) return;
  float a[9], v[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    a[i] = F[b * 9 + i];
    v[i] = i % 4 == 0 ? 1.f : 0.f;
  }
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int q = p + 1; q < 3; ++q) {
        const float alpha = column_dot(a, p, p), beta = column_dot(a, q, q);
        const float gamma = column_dot(a, p, q);
        if (gamma == 0.f) continue;
        const float tau = (beta - alpha) / (2.f * gamma);
        const float t = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(fmaf(tau, tau, 1.f)));
        const float c = 1.f / sqrtf(fmaf(t, t, 1.f));
        const float s = t * c;
        rotate_columns(a, p, q, c, s);
        rotate_columns(v, p, q, c, s);
      }
    }
  }
  // columns by norm, descending and stable; NaN compares false and stays put
  float nrm[3];
  int order[3] = {0, 1, 2};
#pragma unroll
  for (int i = 0; i < 3; ++i) nrm[i] = sqrtf(column_dot(a, i, i));
#pragma unroll
  for (int k = 1; k < 3; ++k)
#pragma unroll
    for (int j = k; j > 0; --j)
      if (nrm[order[j - 1]] < nrm[order[j]]) {
        const int o = order[j];
        order[j] = order[j - 1];
        order[j - 1] = o;
      }
  float col[3][3], vc[3][3];  // col[i]: the column of the i-th largest norm
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      col[i][r] = a[r * 3 + order[i]];
      vc[i][r] = v[r * 3 + order[i]];
    }
  float u[3][3];
  const float s1 = norm3(col[0]);
  if (!unit3(col[0], u[0])) {
    u[0][0] = 1.f;
    u[0][1] = u[0][2] = 0.f;
  }
  const float d = dot3(u[0], col[1]);
  float w2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) w2[i] = col[1][i] - d * u[0][i];
  const float s2 = norm3(w2);
  if (!unit3(w2, u[1])) orthogonal_unit(u[0], u[1]);
  cross3(u[0], u[1], u[2]);
  float s3 = dot3(u[2], col[2]);
  if (s3 < 0.f) {
    s3 = -s3;
#pragma unroll
    for (int r = 0; r < 3; ++r) vc[2][r] = -vc[2][r];
  }
  const float sv[3] = {s1, s2, s3};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    S[b * 3 + i] = sv[i];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      U[b * 9 + r * 3 + i] = u[i][r];
      Vh[b * 9 + i * 3 + r] = vc[i][r];
    }
  }
}

int blocks_for(int batch) { return (batch + WARPS - 1) / WARPS; }

}  // namespace

// A (batch, n, n) float32 contiguous, 1 <= n <= 9; w (batch, n), V (batch,
// n, n) float32 contiguous: eigenvalues ascending, eigenvectors as columns.
extern "C" int far_eigh_small(const void* A, void* w, void* V, int batch, int n, int sweeps,
                              void* stream) {
  if (batch < 1 || n < 1 || n > NMAX || sweeps < 0) return (int)cudaErrorInvalidValue;
  eigh_kernel<<<blocks_for(batch), 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const float*)A, (float*)w, (float*)V, batch, n, sweeps);
  return (int)cudaGetLastError();
}

// F (batch, 3, 3) float32 contiguous -> U (batch, 3, 3), S (batch, 3)
// descending, Vh (batch, 3, 3), all float32 contiguous.
extern "C" int far_svd3(const void* F, void* U, void* S, void* Vh, int batch, int sweeps,
                        void* stream) {
  if (batch < 1 || sweeps < 0) return (int)cudaErrorInvalidValue;
  svd3_kernel<<<(batch + SVD_THREADS - 1) / SVD_THREADS, SVD_THREADS, 0,
                (cudaStream_t)stream>>>(
      (const float*)F, (float*)U, (float*)S, (float*)Vh, batch, sweeps);
  return (int)cudaGetLastError();
}
