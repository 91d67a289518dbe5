// K1: one LoFTR encoder layer with linear attention.
//
// Replaces far_tpu/ops/loftr_layer.py:fused_loftr_layer (the
// pl.pallas_call at :147, body _kernel at :46). Per batch element:
//   q = elu(x Wq)+1, k = elu(src Wk)+1, v = src Wv / S
//   per head: KV = k^T v, Z = 1/(q . sum(k) + 1e-6), msg = (q KV) Z S
//   m = LN1(msg Wm), out = x + LN2(relu(x W0x + m W0m) W1)
// with the +1e-6 normalizer of fused_loftr_layer_reference (:106).
//
// Bound: operations. At L=S=4800, C=256 a layer is ~6.5 GFLOP per pair
// against ~10 MB of tokens in and out, far above the card's ridge point.
// Design: the TPU kernel keeps one batch element in VMEM; an SM's 227 KB
// cannot, so the layer is a chain of launches on the current stream:
// tiled products (64x64 tiles over all B*L rows, epilogues elu+1 / 1/S /
// relu fused), a per-head k^T v reduction split over row chunks with
// deterministic partial sums, a message kernel with the head's KV in
// shared memory, and LayerNorm(+residual) kernels. Intermediates round
// to the storage type where the TPU kernel casts them.
#include "common.cuh"

using namespace far;

namespace {

enum Epi { EPI_NONE = 0, EPI_ELU1 = 1, EPI_DIV = 2, EPI_RELU = 3 };

// C[M, N] = epi(A1 W1^T [+ A2 W2^T]); W are torch Linear weights (N, K).
template <typename T, typename OT, int EPI>
__global__ void __launch_bounds__(NT)
gemm_kernel(const T* __restrict__ A1, int lda1, const T* __restrict__ W1, int ldw1, int K1,
            const T* __restrict__ A2, int lda2, const T* __restrict__ W2, int ldw2, int K2,
            int M, int N, float div, OT* __restrict__ out) {
  __shared__ TileSmem sm;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  float acc[4][4] = {};
  tile_gemm<T, T, true>(A1, lda1, W1, ldw1, M, N, K1, row0, col0, acc, sm);
  if (A2 != nullptr) tile_gemm<T, T, true>(A2, lda2, W2, ldw2, M, N, K2, row0, col0, acc, sm);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      float a = acc[i][j];
      if (EPI == EPI_ELU1) a = elu1(a);
      if (EPI == EPI_DIV) a = a / div;
      if (EPI == EPI_RELU) a = fmaxf(a, 0.f);
      out[(size_t)r * N + c] = from_f<OT>(a);
    }
  }
}

constexpr int KV_ROWS = 256;  // rows of k/v per reduction block
constexpr int KV_SUB = 32;    // rows staged in shared memory at a time
constexpr int KV_PER_THREAD = 8;

// Partial per-head KV = k^T v (d x d) and ksum over KV_ROWS rows.
// Grid (B*H, nsplit). part: (B*H, nsplit, d*d + d).
template <typename T>
__global__ void __launch_bounds__(NT)
kv_partial_kernel(const T* __restrict__ k, const T* __restrict__ v, int S, int C, int H,
                  float* __restrict__ part) {
  extern __shared__ float sh[];
  const int d = C / H;
  float* ks = sh;                // (KV_SUB, d)
  float* vs = sh + KV_SUB * d;   // (KV_SUB, d)
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int s0 = blockIdx.y * KV_ROWS, s1 = min(S, s0 + KV_ROWS);
  const int nel = d * d + d;
  float acc[KV_PER_THREAD] = {};
  for (int sb = s0; sb < s1; sb += KV_SUB) {
    const int nr = min(KV_SUB, s1 - sb);
    for (int e = threadIdx.x; e < KV_SUB * d; e += NT) {
      const int r = e / d, i = e % d;
      const size_t g = ((size_t)b * S + sb + r) * C + h * d + i;
      ks[e] = r < nr ? to_f<T>(k[g]) : 0.f;
      vs[e] = r < nr ? to_f<T>(v[g]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < KV_PER_THREAD; ++t) {
      const int e = threadIdx.x + t * NT;
      if (e >= nel) break;
      float a = acc[t];
      if (e < d * d) {
        const int i = e / d, j = e % d;
        for (int r = 0; r < KV_SUB; ++r) a = fmaf(ks[r * d + i], vs[r * d + j], a);
      } else {
        const int i = e - d * d;
        for (int r = 0; r < KV_SUB; ++r) a += ks[r * d + i];
      }
      acc[t] = a;
    }
    __syncthreads();
  }
  float* o = part + ((size_t)bh * gridDim.y + blockIdx.y) * nel;
#pragma unroll
  for (int t = 0; t < KV_PER_THREAD; ++t) {
    const int e = threadIdx.x + t * NT;
    if (e < nel) o[e] = acc[t];
  }
}

__global__ void kv_reduce_kernel(const float* __restrict__ part, int nbh, int nsplit, int nel,
                                 float* __restrict__ kv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nbh * nel) return;
  const int bh = i / nel, e = i % nel;
  float s = 0.f;
  for (int t = 0; t < nsplit; ++t) s += part[((size_t)bh * nsplit + t) * nel + e];
  kv[i] = s;
}

constexpr int MSG_ROWS = 16;

// msg[r, h*d + j] = (sum_i q[r, hd+i] KV_h[i, j]) * Z[r, h] * S.
// Grid (ceil(L / MSG_ROWS), B). kv: (B, H, d*d + d) with ksum last.
template <typename T>
__global__ void __launch_bounds__(NT)
msg_kernel(const T* __restrict__ q, const float* __restrict__ kv, int L, int S, int C, int H,
           T* __restrict__ msg) {
  extern __shared__ float sh[];
  const int d = C / H, nel = d * d + d;
  float* kvs = sh;                 // (H, nel)
  float* qs = sh + H * nel;        // (MSG_ROWS, C)
  const int b = blockIdx.y, r0 = blockIdx.x * MSG_ROWS;
  const int nr = min(MSG_ROWS, L - r0);
  for (int e = threadIdx.x; e < H * nel; e += NT) kvs[e] = kv[(size_t)b * H * nel + e];
  for (int e = threadIdx.x; e < MSG_ROWS * C; e += NT) {
    const int r = e / C;
    qs[e] = r < nr ? to_f<T>(q[((size_t)b * L + r0) * C + e]) : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * C; e += NT) {
    const int r = e / C, c = e % C, h = c / d, j = c % d;
    const float* qr = qs + r * C + h * d;
    const float* kvh = kvs + h * nel;
    const float* ksum = kvh + d * d;
    float den = 0.f, num = 0.f;
    for (int i = 0; i < d; ++i) {
      den = fmaf(qr[i], ksum[i], den);
      num = fmaf(qr[i], kvh[i * d + j], num);
    }
    const float z = 1.f / (den + 1e-6f);
    msg[((size_t)b * L + r0) * C + e] = from_f<T>(num * z * (float)S);
  }
}

// out[r] = LN(in[r]) * g + b (+ res[r]); one warp per row.
template <typename T>
__global__ void ln_kernel(const float* __restrict__ in, const float* __restrict__ ln,
                          const T* __restrict__ res, int M, int C, T* __restrict__ out) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const float* x = in + (size_t)row * C;
  float mu, rstd;
  warp_row_stats(x, C, mu, rstd);
  for (int j = threadIdx.x & 31; j < C; j += 32) {
    float y = (x[j] - mu) * rstd * ln[j] + ln[C + j];
    if (res != nullptr) y += to_f<T>(res[(size_t)row * C + j]);
    out[(size_t)row * C + j] = from_f<T>(y);
  }
}

template <typename T, typename OT, int EPI>
void gemm(const T* A1, int lda1, const T* W1, int ldw1, int K1, const T* A2, int lda2,
          const T* W2, int ldw2, int K2, int M, int N, float div, OT* out, cudaStream_t st) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  gemm_kernel<T, OT, EPI><<<grid, NT, 0, st>>>(A1, lda1, W1, ldw1, K1, A2, lda2, W2, ldw2, K2,
                                               M, N, div, out);
}

struct Layout {
  char *q, *k, *v, *msg, *m, *y;
  float *mm, *part, *kv;
  size_t bytes;
};

Layout layout(char* base, int esize, int B, int L, int S, int C, int H) {
  const int d = C / H, nel = d * d + d;
  const int nsplit = (S + KV_ROWS - 1) / KV_ROWS;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base + off;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  Layout l;
  l.q = take((size_t)esize * B * L * C);
  l.k = take((size_t)esize * B * S * C);
  l.v = take((size_t)esize * B * S * C);
  l.msg = take((size_t)esize * B * L * C);
  l.m = take((size_t)esize * B * L * C);
  l.y = take((size_t)esize * B * L * 2 * C);
  l.mm = (float*)take(sizeof(float) * B * L * C);
  l.part = (float*)take(sizeof(float) * B * H * nsplit * nel);
  l.kv = (float*)take(sizeof(float) * B * H * nel);
  l.bytes = off;
  return l;
}

template <typename T>
int run(const T* x, const T* src, const T* wq, const T* wk, const T* wv, const T* wm,
        const T* w0, const T* w1, const float* ln1, const float* ln2, T* out, char* scratch,
        int B, int L, int S, int C, int H, cudaStream_t st) {
  const int d = C / H, nel = d * d + d;
  if (C % H != 0 || nel > KV_PER_THREAD * NT) return (int)cudaErrorInvalidValue;
  Layout l = layout(scratch, sizeof(T), B, L, S, C, H);
  T *q = (T*)l.q, *k = (T*)l.k, *v = (T*)l.v, *msg = (T*)l.msg, *m = (T*)l.m, *y = (T*)l.y;
  const int ML = B * L, MS = B * S;
  gemm<T, T, EPI_ELU1>(x, C, wq, C, C, nullptr, 0, nullptr, 0, 0, ML, C, 1.f, q, st);
  gemm<T, T, EPI_ELU1>(src, C, wk, C, C, nullptr, 0, nullptr, 0, 0, MS, C, 1.f, k, st);
  gemm<T, T, EPI_DIV>(src, C, wv, C, C, nullptr, 0, nullptr, 0, 0, MS, C, (float)S, v, st);

  const int nsplit = (S + KV_ROWS - 1) / KV_ROWS;
  kv_partial_kernel<T><<<dim3(B * H, nsplit), NT, sizeof(float) * 2 * KV_SUB * d, st>>>(
      k, v, S, C, H, l.part);
  kv_reduce_kernel<<<(B * H * nel + 255) / 256, 256, 0, st>>>(l.part, B * H, nsplit, nel, l.kv);

  const size_t msg_smem = sizeof(float) * ((size_t)H * nel + MSG_ROWS * C);
  cudaError_t err = cudaFuncSetAttribute(msg_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)msg_smem);
  if (err != cudaSuccess) return (int)err;
  msg_kernel<T><<<dim3((L + MSG_ROWS - 1) / MSG_ROWS, B), NT, msg_smem, st>>>(q, l.kv, L, S, C,
                                                                             H, msg);

  gemm<T, float, EPI_NONE>(msg, C, wm, C, C, nullptr, 0, nullptr, 0, 0, ML, C, 1.f, l.mm, st);
  const int rows_per_block = 8;
  const int ln_grid = (ML + rows_per_block - 1) / rows_per_block;
  ln_kernel<T><<<ln_grid, 32 * rows_per_block, 0, st>>>(l.mm, ln1, nullptr, ML, C, m);
  // mlp.0 weight is (2C, 2C): its first C input columns take x, the rest m
  gemm<T, T, EPI_RELU>(x, C, w0, 2 * C, C, m, C, w0 + C, 2 * C, C, ML, 2 * C, 1.f, y, st);
  gemm<T, float, EPI_NONE>(y, 2 * C, w1, 2 * C, 2 * C, nullptr, 0, nullptr, 0, 0, ML, C, 1.f,
                           l.mm, st);
  ln_kernel<T><<<ln_grid, 32 * rows_per_block, 0, st>>>(l.mm, ln2, x, ML, C, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t far_loftr_layer_scratch(int dtype, int B, int L, int S, int C, int H) {
  return layout(nullptr, dtype == 0 ? 4 : 2, B, L, S, C, H).bytes;
}

// x (B, L, C), src (B, S, C); wq/wk/wv/wm (C, C), w0 (2C, 2C), w1 (C, 2C)
// torch Linear weights in the storage type; ln1/ln2 (2, C) float32
// [weight; bias]. dtype: 0 = float32, 1 = bfloat16.
extern "C" int far_loftr_layer(const void* x, const void* src, const void* wq, const void* wk,
                               const void* wv, const void* wm, const void* w0, const void* w1,
                               const void* ln1, const void* ln2, void* out, void* scratch,
                               int B, int L, int S, int C, int H, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>((const float*)x, (const float*)src, (const float*)wq, (const float*)wk,
                      (const float*)wv, (const float*)wm, (const float*)w0, (const float*)w1,
                      (const float*)ln1, (const float*)ln2, (float*)out, (char*)scratch, B, L,
                      S, C, H, st);
  using bf = __nv_bfloat16;
  return run<bf>((const bf*)x, (const bf*)src, (const bf*)wq, (const bf*)wk, (const bf*)wv,
                 (const bf*)wm, (const bf*)w0, (const bf*)w1, (const float*)ln1,
                 (const float*)ln2, (bf*)out, (char*)scratch, B, L, S, C, H, st);
}
