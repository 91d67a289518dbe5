// K3: the whole fine LoFTR transformer over 5x5 windows.
//
// Replaces far_tpu/ops/fine_layer.py:_fused (the pl.pallas_call at :246,
// body _kernel at :144 with _layer_body at :74). Input: n windows of s
// tokens per image, (n, s, C). Every layer application of the stack
// (self, cross; both directions; cross is sequential, so f1 attends to
// the updated f0) runs on windows that never leave shared memory, with
// linear attention confined to each window.
//
// Bound: operations. At B=4, K=1024 windows, s=25, C=128 the stack is
// ~35 GFLOP per pair on ~26 MB of tokens in and out. Design: one block
// owns WPB windows (R = WPB*s <= 64 rows per tile), holds both images'
// tokens and the layer's intermediates in shared memory as f32 (about
// 145 KB at C=128) and streams the weights from L2 through the same
// 64x64 tile product as K1 (common.cuh). Per window and head, KV = k^T v
// and sum(k) are reduced in shared memory; the message, LayerNorm and
// residual never touch device memory. Values round to the storage type
// where the TPU kernel casts them.
#include "common.cuh"

using namespace far;

namespace {

constexpr int WPB = 2;  // windows per block

enum Epi { EPI_NONE = 0, EPI_ELU1 = 1, EPI_DIV = 2, EPI_RELU = 3 };

// out[R, N] = epi(X W^T [+ X2 W2^T]), X in shared memory (f32), W torch
// Linear weights (N, K) in device memory.
template <typename T, int EPI, bool RND>
__device__ void block_gemm(const float* X, int ldx, const T* W, int ldw, const float* X2,
                           int ldx2, const T* W2, int ldw2, int K, int R, int N, float div,
                           float* out, int ldo, TileSmem& sm) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int r0 = 0; r0 < R; r0 += TM) {
    for (int n0 = 0; n0 < N; n0 += TN) {
      float acc[4][4] = {};
      tile_gemm<float, T, true>(X, ldx, W, ldw, R, N, K, r0, n0, acc, sm);
      if (X2 != nullptr) tile_gemm<float, T, true>(X2, ldx2, W2, ldw2, R, N, K, r0, n0, acc, sm);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + tx + 16 * j;
          if (r >= R || c >= N) continue;
          float a = acc[i][j];
          if (EPI == EPI_ELU1) a = elu1(a);
          if (EPI == EPI_DIV) a = a / div;
          if (EPI == EPI_RELU) a = fmaxf(a, 0.f);
          out[r * ldo + c] = RND ? rnd<T>(a) : a;
        }
      }
    }
  }
  __syncthreads();
}

// rows[r] = LN(z[r]) * g + b (+ rows[r] when residual), one warp per row.
template <typename T>
__device__ void block_ln(float* z, int R, int C, const float* ln, float* rows, bool residual) {
  const int warp = threadIdx.x / 32, nw = blockDim.x / 32, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += nw) {
    float* x = z + r * C;
    float mu, rstd;
    warp_row_stats(x, C, mu, rstd);
    for (int j = lane; j < C; j += 32) {
      const float y = (x[j] - mu) * rstd * ln[j] + ln[C + j];
      rows[r * C + j] = rnd<T>(residual ? rows[r * C + j] + y : y);
    }
  }
  __syncthreads();
}

// One LoFTR encoder layer, X <- layer(X, Y), on R rows of WPB windows.
template <typename T>
__device__ void layer(float* X, const float* Y, float* P1, float* P2, float* KV, const T* w,
                      const float* ln, int R, int s, int C, int H, TileSmem& sm) {
  const int d = C / H, nel = d * d + d, C2 = C * C;
  const T *wq = w, *wk = w + C2, *wv = w + 2 * C2, *wm = w + 3 * C2, *w0 = w + 4 * C2,
          *w1 = w + 8 * C2;
  float* q = P1;      // (R, 2C) rows: q | k, later q | msg, later y
  float* k = P1 + C;
  block_gemm<T, EPI_ELU1, true>(X, C, wq, C, nullptr, 0, nullptr, 0, C, R, C, 1.f, q, 2 * C, sm);
  block_gemm<T, EPI_ELU1, true>(Y, C, wk, C, nullptr, 0, nullptr, 0, C, R, C, 1.f, k, 2 * C, sm);
  block_gemm<T, EPI_DIV, true>(Y, C, wv, C, nullptr, 0, nullptr, 0, C, R, C, (float)s, P2, C,
                               sm);
  // per window and head: KV = k^T v (d x d) and sum(k)
  const int nwin = R / s;
  for (int e = threadIdx.x; e < nwin * H * nel; e += blockDim.x) {
    const int wh = e / nel, i0 = e % nel, win = wh / H, h = wh % H;
    const float* kr = k + (win * s) * 2 * C + h * d;
    const float* vr = P2 + (win * s) * C + h * d;
    float a = 0.f;
    if (i0 < d * d) {
      const int i = i0 / d, j = i0 % d;
      for (int t = 0; t < s; ++t) a = fmaf(kr[t * 2 * C + i], vr[t * C + j], a);
    } else {
      const int i = i0 - d * d;
      for (int t = 0; t < s; ++t) a += kr[t * 2 * C + i];
    }
    KV[e] = a;
  }
  __syncthreads();
  // msg overwrites k
  for (int e = threadIdx.x; e < R * C; e += blockDim.x) {
    const int r = e / C, c = e % C, h = c / d, j = c % d, win = r / s;
    const float* qr = q + r * 2 * C + h * d;
    const float* kvh = KV + (win * H + h) * nel;
    const float* ksum = kvh + d * d;
    float den = 0.f, num = 0.f;
    for (int i = 0; i < d; ++i) {
      den = fmaf(qr[i], ksum[i], den);
      num = fmaf(qr[i], kvh[i * d + j], num);
    }
    k[r * 2 * C + c] = rnd<T>(num * (1.f / (den + 1e-6f)) * (float)s);
  }
  __syncthreads();
  // m = LN1(msg Wm) into P2
  block_gemm<T, EPI_NONE, false>(k, 2 * C, wm, C, nullptr, 0, nullptr, 0, C, R, C, 1.f, P2, C,
                                 sm);
  block_ln<T>(P2, R, C, ln, P2, false);
  // y = relu(X W0x + m W0m) into P1 (R, 2C)
  block_gemm<T, EPI_RELU, true>(X, C, w0, 2 * C, P2, C, w0 + C, 2 * C, C, R, 2 * C, 1.f, P1,
                                2 * C, sm);
  // X = X + LN2(y W1)
  block_gemm<T, EPI_NONE, false>(P1, 2 * C, w1, 2 * C, nullptr, 0, nullptr, 0, 2 * C, R, C, 1.f,
                                 P2, C, sm);
  block_ln<T>(P2, R, C, ln + 2 * C, X, true);
}

template <typename T>
__global__ void __launch_bounds__(NT)
fine_kernel(const T* __restrict__ f0, const T* __restrict__ f1, const T* __restrict__ w,
            const float* __restrict__ ln, T* __restrict__ out0, T* __restrict__ out1, int n, int s,
            int C, int H, int n_layers, int cross_mask) {
  extern __shared__ float sh[];
  __shared__ TileSmem sm;
  const int R = WPB * s;
  const int w0 = blockIdx.x * WPB, nwin = min(WPB, n - w0);
  const size_t base = (size_t)w0 * s * C;
  const int nvalid = nwin * s * C;
  float* X0 = sh;
  float* X1 = X0 + R * C;
  float* P1 = X1 + R * C;
  float* P2 = P1 + 2 * R * C;
  float* KV = P2 + R * C;
  for (int e = threadIdx.x; e < R * C; e += NT) {
    X0[e] = e < nvalid ? to_f<T>(f0[base + e]) : 0.f;
    X1[e] = e < nvalid ? to_f<T>(f1[base + e]) : 0.f;
  }
  __syncthreads();
  const size_t wstride = (size_t)10 * C * C;
  for (int li = 0; li < n_layers; ++li) {
    const T* wl = w + li * wstride;
    const float* lnl = ln + li * 4 * C;
    if ((cross_mask >> li) & 1) {
      layer<T>(X0, X1, P1, P2, KV, wl, lnl, R, s, C, H, sm);
      layer<T>(X1, X0, P1, P2, KV, wl, lnl, R, s, C, H, sm);
    } else {
      layer<T>(X0, X0, P1, P2, KV, wl, lnl, R, s, C, H, sm);
      layer<T>(X1, X1, P1, P2, KV, wl, lnl, R, s, C, H, sm);
    }
  }
  for (int e = threadIdx.x; e < nvalid; e += NT) {
    out0[base + e] = from_f<T>(X0[e]);
    out1[base + e] = from_f<T>(X1[e]);
  }
}

template <typename T>
int run(const T* f0, const T* f1, const T* w, const float* ln, T* out0, T* out1, int n, int s,
        int C, int H, int n_layers, int cross_mask, cudaStream_t st) {
  if (C % H != 0 || n_layers > 30) return (int)cudaErrorInvalidValue;
  const int d = C / H, R = WPB * s;
  const size_t smem = sizeof(float) * ((size_t)5 * R * C + (size_t)WPB * H * (d * d + d));
  cudaError_t err = cudaFuncSetAttribute(fine_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fine_kernel<T><<<(n + WPB - 1) / WPB, NT, smem, st>>>(f0, f1, w, ln, out0, out1, n, s, C, H,
                                                        n_layers, cross_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// f0, f1 (n, s, C); w: per layer [wq wk wv wm (C,C) | w0 (2C,2C) | w1 (C,2C)]
// torch Linear weights in the storage type; ln: per layer [ln1; ln2] (4, C)
// float32. Bit li of cross_mask marks layer li as cross attention.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int far_fine_transformer(const void* f0, const void* f1, const void* w,
                                    const void* ln, void* out0, void* out1, int n, int s, int C,
                                    int H, int n_layers, int cross_mask, int dtype,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>((const float*)f0, (const float*)f1, (const float*)w, (const float*)ln,
                      (float*)out0, (float*)out1, n, s, C, H, n_layers, cross_mask, st);
  using bf = __nv_bfloat16;
  return run<bf>((const bf*)f0, (const bf*)f1, (const bf*)w, (const float*)ln, (bf*)out0,
                 (bf*)out1, n, s, C, H, n_layers, cross_mask, st);
}
