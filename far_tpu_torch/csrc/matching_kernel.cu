// K2: dual-softmax match reductions.
//
// Replaces far_tpu/ops/matching_kernel.py:dual_softmax_rowcol (the
// pl.pallas_call at :125, body _kernel at :30). For S = inv_temp * f0 f1^T
// and conf = softmax_rows(S) * softmax_cols(S) it returns each row's max
// conf and its first argmax, and each column's max conf. conf is never
// stored: at B=4, L=S=4800 it would be 369 MB of f32.
//
// Bound: operations. S costs 2*L*S*C = 11.8 GFLOP per pair and is
// computed twice (statistics pass, then the conf pass); the bytes moved
// are the two (L, C) bf16 inputs and three (L,) outputs, a few MB.
// Design: both passes walk 64x64 tiles of S, every tile an independent
// block (the TPU kernel's sequential grid loop becomes the tile grid).
// Cross-block reductions go through per-tile partials and a combine
// kernel, not atomics, so the result is the same on every run and the
// argmax keeps the first index on ties as jnp.argmax does.
#include "common.cuh"

using namespace far;

namespace {

template <typename T>
__global__ void __launch_bounds__(NT)
conf_tile_kernel(const T* __restrict__ f0, const T* __restrict__ f1, int L, int S, int C,
                 float inv_temp, const float* __restrict__ rmax, const float* __restrict__ rsum,
                 const float* __restrict__ cmax, const float* __restrict__ csum,
                 float* __restrict__ prv, long long* __restrict__ pri,
                 float* __restrict__ pcm) {
  __shared__ TileSmem sm;
  __shared__ float st[TM][TN + 1];
  const int bt = blockIdx.z, row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const int nct = gridDim.x, nrt = gridDim.y;
  float acc[4][4] = {};
  tile_gemm<T, T, true>(f0 + (size_t)bt * L * C, C, f1 + (size_t)bt * S * C, C, L, S, C,
                        row0, col0, acc, sm);
  store_tile(acc, st, inv_temp);
  __syncthreads();
  const int nr = min(TM, L - row0), nc = min(TN, S - col0);
  // conf in place
  for (int e = threadIdx.x; e < TM * TN; e += NT) {
    const int r = e / TN, c = e % TN;
    if (r < nr && c < nc) {
      const float s = st[r][c];
      const size_t ri = (size_t)bt * L + row0 + r, ci = (size_t)bt * S + col0 + c;
      st[r][c] = (expf(s - rmax[ri]) / rsum[ri]) * (expf(s - cmax[ci]) / csum[ci]);
    }
  }
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < TM) {
    const int r = tid;
    if (r < nr) {
      float best = -INFINITY;
      int arg = 0;
      for (int c = 0; c < nc; ++c) {
        if (st[r][c] > best) {
          best = st[r][c];
          arg = c;
        }
      }
      const size_t o = ((size_t)bt * L + row0 + r) * nct + blockIdx.x;
      prv[o] = best;
      pri[o] = col0 + arg;
    }
  } else if (tid < TM + TN) {
    const int c = tid - TM;
    if (c < nc) {
      float best = -INFINITY;
      for (int r = 0; r < nr; ++r) best = fmaxf(best, st[r][c]);
      pcm[((size_t)bt * S + col0 + c) * nrt + blockIdx.y] = best;
    }
  }
}

__global__ void row_combine_kernel(const float* __restrict__ prv,
                                   const long long* __restrict__ pri, int n, int nt,
                                   float* __restrict__ row_val, long long* __restrict__ row_idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best = -INFINITY;
  long long arg = 0;
  for (int t = 0; t < nt; ++t) {  // ascending tiles: strict > keeps the first index
    const float v = prv[(size_t)i * nt + t];
    if (v > best) {
      best = v;
      arg = pri[(size_t)i * nt + t];
    }
  }
  row_val[i] = best;
  row_idx[i] = arg;
}

__global__ void col_combine_kernel(const float* __restrict__ pcm, int n, int nt,
                                   float* __restrict__ col_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best = -INFINITY;
  for (int t = 0; t < nt; ++t) best = fmaxf(best, pcm[(size_t)i * nt + t]);
  col_max[i] = best;
}

struct Layout {
  float *dsm, *rmax, *rsum, *cmax, *csum, *prv, *pcm;
  long long* pri;
  size_t bytes;
};

Layout layout(char* base, int B, int L, int S) {
  const size_t nct = (S + TN - 1) / TN, nrt = (L + TM - 1) / TM;
  size_t off = 0;
  Layout l;
  auto take = [&](size_t bytes) {
    char* p = base + off;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  l.pri = (long long*)take(sizeof(long long) * B * L * nct);
  l.dsm = (float*)take(sizeof(float) * dsm_scratch_floats(B, L, S));
  l.rmax = (float*)take(sizeof(float) * B * L);
  l.rsum = (float*)take(sizeof(float) * B * L);
  l.cmax = (float*)take(sizeof(float) * B * S);
  l.csum = (float*)take(sizeof(float) * B * S);
  l.prv = (float*)take(sizeof(float) * B * L * nct);
  l.pcm = (float*)take(sizeof(float) * B * S * nrt);
  l.bytes = off;
  return l;
}

template <typename T>
void run(const T* f0, const T* f1, float* row_val, long long* row_idx, float* col_max,
         char* scratch, int B, int L, int S, int C, float inv_temp, cudaStream_t st) {
  Layout l = layout(scratch, B, L, S);
  launch_dsm_stats<T>(f0, f1, B, L, S, C, inv_temp, l.dsm, l.rmax, l.rsum, l.cmax, l.csum, st);
  const int nct = (S + TN - 1) / TN, nrt = (L + TM - 1) / TM;
  conf_tile_kernel<T><<<dim3(nct, nrt, B), NT, 0, st>>>(
      f0, f1, L, S, C, inv_temp, l.rmax, l.rsum, l.cmax, l.csum, l.prv, l.pri, l.pcm);
  row_combine_kernel<<<(B * L + 255) / 256, 256, 0, st>>>(l.prv, l.pri, B * L, nct, row_val,
                                                          row_idx);
  col_combine_kernel<<<(B * S + 255) / 256, 256, 0, st>>>(l.pcm, B * S, nrt, col_max);
}

}  // namespace

extern "C" size_t far_dual_softmax_scratch(int B, int L, int S) {
  return layout(nullptr, B, L, S).bytes;
}

// dtype: 0 = float32, 1 = bfloat16. f0 (B, L, C), f1 (B, S, C) contiguous.
extern "C" int far_dual_softmax_rowcol(const void* f0, const void* f1, void* row_val,
                                       void* row_idx, void* col_max, void* scratch, int B,
                                       int L, int S, int C, int dtype, float inv_temp,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    run<float>((const float*)f0, (const float*)f1, (float*)row_val, (long long*)row_idx,
               (float*)col_max, (char*)scratch, B, L, S, C, inv_temp, st);
  else
    run<__nv_bfloat16>((const __nv_bfloat16*)f0, (const __nv_bfloat16*)f1, (float*)row_val,
                       (long long*)row_idx, (float*)col_max, (char*)scratch, B, L, S, C,
                       inv_temp, st);
  return (int)cudaGetLastError();
}
