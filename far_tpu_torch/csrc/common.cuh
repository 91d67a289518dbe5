// Device building blocks shared by the port's CUDA kernels.
//
// - to_f / from_f / rnd: float <-> storage type (float or bf16); rnd
//   rounds an f32 value through the storage type, so a kernel can round
//   at the same points as the JAX kernel it replaces.
// - tile_gemm: one 64x64 output tile of A(MxK) . B, B given as (KxN)
//   row-major or as (NxK) row-major ("transposed", a torch Linear weight
//   or the second operand of q k^T). 256 threads, 4x4 outputs each, f32
//   accumulation on the CUDA cores. Simple and right first; a wgmma/TMA
//   pipeline is later work.
// - dsm_stats_kernel / dsm_combine_kernel: the column and row
//   (max, sum of exp) statistics of S = scale * A B^T, streamed in
//   64x64 tiles and never stored whole. The dual-softmax kernels
//   (matching_kernel.cu, bilinear_attention.cu) share them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace far {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int NT = 256;  // threads of a tile block

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm statistics (eps 1e-5, torch's default) of one row of C
// floats, computed by the calling warp: mean, then the mean square of
// the centred row, as far_tpu/ops/loftr_layer.py:_ln does.
__device__ __forceinline__ void warp_row_stats(const float* row, int C, float& mu,
                                               float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int j = lane; j < C; j += 32) s += row[j];
  mu = warp_sum(s) / C;
  float v = 0.f;
  for (int j = lane; j < C; j += 32) {
    const float d = row[j] - mu;
    v += d * d;
  }
  rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
}

struct TileSmem {
  float a[TK][TM + 4];
  float b[TK][TN + 4];
};

// acc[i][j] += sum_k A[row0 + ty + 16 i, k] * B[k, col0 + tx + 16 j]
// with tx = tid % 16, ty = tid / 16. Out-of-range rows/cols read 0.
template <typename TA, typename TB, bool BT>
__device__ __forceinline__ void tile_gemm(const TA* __restrict__ A, int lda,
                                          const TB* __restrict__ B, int ldb,
                                          int M, int N, int K, int row0, int col0,
                                          float acc[4][4], TileSmem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TK * TM; e += NT) {
      const int m = e / TK, k = e % TK;
      const int gr = row0 + m, gk = k0 + k;
      sm.a[k][m] = (gr < M && gk < K) ? to_f<TA>(A[(size_t)gr * lda + gk]) : 0.f;
    }
    for (int e = tid; e < TK * TN; e += NT) {
      if (BT) {
        const int n = e / TK, k = e % TK;
        const int gn = col0 + n, gk = k0 + k;
        sm.b[k][n] = (gn < N && gk < K) ? to_f<TB>(B[(size_t)gn * ldb + gk]) : 0.f;
      } else {
        const int k = e / TN, n = e % TN;
        const int gn = col0 + n, gk = k0 + k;
        sm.b[k][n] = (gn < N && gk < K) ? to_f<TB>(B[(size_t)gk * ldb + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// S tile (scaled) into shared memory: st[r][c] for the block's 64x64 tile.
__device__ __forceinline__ void store_tile(const float acc[4][4], float (*st)[TN + 1],
                                           float scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) st[ty + 16 * i][tx + 16 * j] = acc[i][j] * scale;
}

// Grid (ceil(S/64), ceil(L/64), batch). For S = scale * A B^T with A
// (batch, L, D) and B (batch, S, D): per row and tile column, the max and
// sum of exp(S - max) over the tile's columns -> prmax/prsum
// (batch, L, nct); per column and tile row the same over the tile's rows
// -> pcmax/pcsum (batch, S, nrt).
template <typename T>
__global__ void __launch_bounds__(NT)
dsm_stats_kernel(const T* __restrict__ A, const T* __restrict__ B, int L, int S, int D,
                 float scale, float* __restrict__ prmax, float* __restrict__ prsum,
                 float* __restrict__ pcmax, float* __restrict__ pcsum) {
  __shared__ TileSmem sm;
  __shared__ float st[TM][TN + 1];
  const int bt = blockIdx.z, row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const int nct = gridDim.x, nrt = gridDim.y;
  float acc[4][4] = {};
  tile_gemm<T, T, true>(A + (size_t)bt * L * D, D, B + (size_t)bt * S * D, D, L, S, D,
                        row0, col0, acc, sm);
  store_tile(acc, st, scale);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < TM) {
    const int r = tid, gr = row0 + r;
    const int nc = min(TN, S - col0);
    if (gr < L) {
      float m = -INFINITY;
      for (int c = 0; c < nc; ++c) m = fmaxf(m, st[r][c]);
      float s = 0.f;
      for (int c = 0; c < nc; ++c) s += expf(st[r][c] - m);
      const size_t o = ((size_t)bt * L + gr) * nct + blockIdx.x;
      prmax[o] = m;
      prsum[o] = s;
    }
  } else if (tid < TM + TN) {
    const int c = tid - TM, gc = col0 + c;
    const int nr = min(TM, L - row0);
    if (gc < S) {
      float m = -INFINITY;
      for (int r = 0; r < nr; ++r) m = fmaxf(m, st[r][c]);
      float s = 0.f;
      for (int r = 0; r < nr; ++r) s += expf(st[r][c] - m);
      const size_t o = ((size_t)bt * S + gc) * nrt + blockIdx.y;
      pcmax[o] = m;
      pcsum[o] = s;
    }
  }
}

// Merge n rows of nt partial (max, sum of exp) pairs into one pair each.
__global__ void dsm_combine_kernel(const float* __restrict__ pmax,
                                   const float* __restrict__ psum, int n, int nt,
                                   float* __restrict__ omax, float* __restrict__ osum) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* pm = pmax + (size_t)i * nt;
  const float* ps = psum + (size_t)i * nt;
  float m = -INFINITY;
  for (int t = 0; t < nt; ++t) m = fmaxf(m, pm[t]);
  float s = 0.f;
  for (int t = 0; t < nt; ++t) s += ps[t] * expf(pm[t] - m);
  omax[i] = m;
  osum[i] = s;
}

// Row and column softmax statistics of S = scale * A B^T for `batch`
// independent (L x S) problems. Scratch: 2 * batch * (L * nct + S * nrt)
// floats. Outputs rmax/rsum (batch, L), cmax/csum (batch, S).
template <typename T>
inline void launch_dsm_stats(const T* A, const T* B, int batch, int L, int S, int D,
                             float scale, float* scratch, float* rmax, float* rsum,
                             float* cmax, float* csum, cudaStream_t st) {
  const int nct = (S + TN - 1) / TN, nrt = (L + TM - 1) / TM;
  float* prmax = scratch;
  float* prsum = prmax + (size_t)batch * L * nct;
  float* pcmax = prsum + (size_t)batch * L * nct;
  float* pcsum = pcmax + (size_t)batch * S * nrt;
  dim3 grid(nct, nrt, batch);
  dsm_stats_kernel<T><<<grid, NT, 0, st>>>(A, B, L, S, D, scale, prmax, prsum, pcmax, pcsum);
  const int nr = batch * L, nc = batch * S;
  dsm_combine_kernel<<<(nr + 255) / 256, 256, 0, st>>>(prmax, prsum, nr, nct, rmax, rsum);
  dsm_combine_kernel<<<(nc + 255) / 256, 256, 0, st>>>(pcmax, pcsum, nc, nrt, cmax, csum);
}

inline size_t dsm_scratch_floats(int batch, int L, int S) {
  const size_t nct = (S + TN - 1) / TN, nrt = (L + TM - 1) / TM;
  return 2 * (size_t)batch * (L * nct + S * nrt);
}

}  // namespace far
