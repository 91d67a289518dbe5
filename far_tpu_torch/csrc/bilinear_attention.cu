// K4: dual-softmax bilinear attention of the EMM regressor.
//
// Replaces far_tpu/ops/bilinear_attention.py:bilinear_dual_softmax (the
// pl.pallas_call at :171 in _dispatch, body _kernel at :36). Per (batch,
// head): S = scale q k^T (N x N), A = softmax_rows(S) * softmax_cols(S),
// F = v^T A v (Dv x Dv, f32). A is never stored: at N=4800 one head's A
// is 92 MB of f32.
//
// Bound: operations. Per head, S costs 2 N^2 D and G = v^T A costs
// 2 N^2 Dv (24.7 GFLOP per pair at N=4800, 4 heads, D=64, Dv=70); the
// inputs are a few MB. Design: a statistics pass over 64x64 tiles of S
// (shared with K2, common.cuh) gives the row and column (max, sum of
// exp); then one block per (head, 64-column tile) walks every row tile,
// rebuilds its tile of A and accumulates G[:, tile] = v^T A in f32 in
// shared memory, and ends with its partial F = G v[tile]. A small kernel
// sums the partials, so the result is the same on every run.
#include "common.cuh"

using namespace far;

namespace {

template <typename T>
__global__ void __launch_bounds__(NT)
bilinear_tile_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     int N, int D, int Dv, float scale, const float* __restrict__ rmax,
                     const float* __restrict__ rsum, const float* __restrict__ cmax,
                     const float* __restrict__ csum, float* __restrict__ fpart) {
  __shared__ TileSmem sm;
  __shared__ float st[TM][TN + 1];
  extern __shared__ float dyn[];
  float* G = dyn;             // (Dv, TN)
  float* vt = dyn + Dv * TN;  // (TM, Dv) rows of v
  const int bh = blockIdx.y, col0 = blockIdx.x * TN;
  const int nct = gridDim.x;
  const T* qb = q + (size_t)bh * N * D;
  const T* kb = k + (size_t)bh * N * D;
  const T* vb = v + (size_t)bh * N * Dv;
  const float* rm = rmax + (size_t)bh * N;
  const float* rs = rsum + (size_t)bh * N;
  const float* cm = cmax + (size_t)bh * N;
  const float* cs = csum + (size_t)bh * N;
  const int nc = min(TN, N - col0);
  for (int e = threadIdx.x; e < Dv * TN; e += NT) G[e] = 0.f;

  for (int row0 = 0; row0 < N; row0 += TM) {
    float acc[4][4] = {};
    tile_gemm<T, T, true>(qb, D, kb, D, N, N, D, row0, col0, acc, sm);
    store_tile(acc, st, scale);
    const int nr = min(TM, N - row0);
    for (int e = threadIdx.x; e < TM * Dv; e += NT) {
      const int r = e / Dv, u = e % Dv;
      vt[e] = r < nr ? to_f<T>(vb[(size_t)(row0 + r) * Dv + u]) : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TM * TN; e += NT) {
      const int r = e / TN, c = e % TN;
      float a = 0.f;
      if (r < nr && c < nc) {
        const float s = st[r][c];
        const int n = row0 + r, m = col0 + c;
        a = (expf(s - rm[n]) / rs[n]) * (expf(s - cm[m]) / cs[m]);
      }
      st[r][c] = a;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < Dv * TN; e += NT) {
      const int u = e / TN, c = e % TN;
      float g = G[e];
      for (int r = 0; r < TM; ++r) g = fmaf(vt[r * Dv + u], st[r][c], g);
      G[e] = g;
    }
    __syncthreads();
  }
  // partial F[u, w] = sum_c G[u, c] v[col0 + c, w]
  for (int e = threadIdx.x; e < TN * Dv; e += NT) {
    const int c = e / Dv, w = e % Dv;
    vt[e] = c < nc ? to_f<T>(vb[(size_t)(col0 + c) * Dv + w]) : 0.f;
  }
  __syncthreads();
  float* out = fpart + ((size_t)bh * nct + blockIdx.x) * Dv * Dv;
  for (int e = threadIdx.x; e < Dv * Dv; e += NT) {
    const int u = e / Dv, w = e % Dv;
    float f = 0.f;
    for (int c = 0; c < TN; ++c) f = fmaf(G[u * TN + c], vt[c * Dv + w], f);
    out[e] = f;
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ fpart, int nbh, int nt, int dd,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nbh * dd) return;
  const int bh = i / dd, e = i % dd;
  float s = 0.f;
  for (int t = 0; t < nt; ++t) s += fpart[((size_t)bh * nt + t) * dd + e];
  out[i] = s;
}

struct Layout {
  float *dsm, *rmax, *rsum, *cmax, *csum, *fpart;
  size_t bytes;
};

Layout layout(char* base, int BH, int N, int Dv) {
  const size_t nct = (N + TN - 1) / TN;
  size_t off = 0;
  Layout l;
  auto take = [&](size_t floats) {
    float* p = (float*)(base + off);
    off += (floats * sizeof(float) + 255) / 256 * 256;
    return p;
  };
  l.dsm = take(dsm_scratch_floats(BH, N, N));
  l.rmax = take((size_t)BH * N);
  l.rsum = take((size_t)BH * N);
  l.cmax = take((size_t)BH * N);
  l.csum = take((size_t)BH * N);
  l.fpart = take((size_t)BH * nct * Dv * Dv);
  l.bytes = off;
  return l;
}

template <typename T>
int run(const T* q, const T* k, const T* v, float* out, char* scratch, int BH, int N, int D,
        int Dv, float scale, cudaStream_t st) {
  Layout l = layout(scratch, BH, N, Dv);
  launch_dsm_stats<T>(q, k, BH, N, N, D, scale, l.dsm, l.rmax, l.rsum, l.cmax, l.csum, st);
  const int nct = (N + TN - 1) / TN;
  const size_t dyn = sizeof(float) * (size_t)(Dv * TN + TM * Dv);
  cudaError_t err = cudaFuncSetAttribute(bilinear_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  bilinear_tile_kernel<T><<<dim3(nct, BH), NT, dyn, st>>>(q, k, v, N, D, Dv, scale, l.rmax,
                                                          l.rsum, l.cmax, l.csum, l.fpart);
  const int n = BH * Dv * Dv;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(l.fpart, BH, nct, Dv * Dv, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t far_bilinear_scratch(int BH, int N, int Dv) {
  return layout(nullptr, BH, N, Dv).bytes;
}

// q, k (BH, N, D), v (BH, N, Dv) contiguous; out (BH, Dv, Dv) float32.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int far_bilinear_dual_softmax(const void* q, const void* k, const void* v, void* out,
                                         void* scratch, int BH, int N, int D, int Dv, int dtype,
                                         float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>((const float*)q, (const float*)k, (const float*)v, (float*)out,
                      (char*)scratch, BH, N, D, Dv, scale, st);
  return run<__nv_bfloat16>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                            (const __nv_bfloat16*)v, (float*)out, (char*)scratch, BH, N, D, Dv,
                            scale, st);
}
