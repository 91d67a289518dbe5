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
// against ~7 MB of tokens in and out, far above the card's ridge point
// (6.6 us per pair at 989 TFLOP/s bf16, 97 us at 67 TFLOP/s f32).
//
// CUDA-core route (far_loftr_layer; shapes outside the tensor-core routes'
// sets in either dtype, such as C = 32 or a head width of 24): the TPU kernel
// keeps one batch element in VMEM; an SM's 227 KB cannot, so the layer is
// a chain of 11 launches on the CUDA cores: tiled products (64x64 tiles
// over all B*L rows, epilogues elu+1 / 1/S / relu fused), a per-head
// k^T v reduction split over row chunks with deterministic partial sums,
// a message kernel with the head's KV in shared memory, and
// LayerNorm(+residual) kernels. In bf16 the products accumulate in f32
// and the intermediates round where the TPU kernel casts them.
//
// bfloat16 route (far_loftr_layer_tc), three launches, every product on
// the tensor cores (wgmma, hopper.cuh), operands staged by cp.async:
//  (a) kv_pass: one block per (b, 64 src rows). k^T and v^T come out of
//      wgmma as W . src^T (M = feature, N = src row), so k^T is already
//      the register A operand of the per-64-feature-group k^T v product
//      and v^T is stored K-major for its B operand. Writes the per-head
//      KV (d x d) and sum(k) partials of the chunk.
//  (b) kv_reduce: sums the partials in chunk order (the same result on
//      every run) into a bf16 block-diagonal KV per 64-column group and
//      f32 sum(k).
//  (c) row_pass: one block per 128 rows of one batch element, two
//      warpgroups of 64 rows. The x tile and msg/m stay in shared memory;
//      q, y and the products' accumulators stay in registers; the
//      weights (and the block-diagonal KV) stream through two 32 KB
//      cp.async stages: Wq, KV, Wm, then per 64-column chunk of y the x
//      and m halves of W0 and the matching 64 columns of W1. y is never
//      whole: each chunk goes relu -> bf16 A fragments -> += y W1^T.
//      LayerNorm runs in the accumulators: a row lives in one quad of
//      threads, so its statistics are two shuffles.
// Only x, src, out, the weights and the KV / sum(k) partials touch
// device memory. What holds it back on the card: within a block each
// weight tile's chain - barrier, wgmma, wait, epilogue - runs in series
// (no producer warp, no ping-pong between the warpgroups yet); a third
// weight stage, tried, was slower (more spills), so the ~1 MB of weights
// a row block streams from L2 is not the limit.
// Rounding to bf16 where the TPU kernel casts: k, v (:68-69), KV (:72),
// q (:75), msg (:80), m (:83), y (:85), out (:88); sum(k), z and the
// LayerNorms stay f32 as there.
//
// float32 route (far_loftr_layer_tf32), 3xTF32 on the tensor cores, 10
// launches: the CUDA-core route's chain with its five dense products
// (q; k; v; m = LN1(msg Wm^T); y = relu(x W0x^T + m W0m^T); out = x +
// LN2(y W1^T)) as 3xTF32 wgmma GEMMs, each product three TF32 products of
// split operands (hopper.cuh; ops/tf32.py models it), elu + 1, 1/S, relu
// and LayerNorm (+ residual, the block spans the row) in their
// epilogues, and the per-head k^T v and q KV (~2.5 % of the operations)
// on the CUDA cores in float32. Bound on this card: operations (~13 GFLOP
// at B=2, 4800 tokens: ~0.08 ms as three TF32 passes at 495 TFLOP/s). The
// bfloat16 route's fused row pass does not carry over: in float32 with
// big and small copies, a 64-row block's x tile, msg/m and two split
// weight stages need 256 KB of shared memory (227 KB a block) before x or
// msg is split, and q split into A fragments would take 256 registers a
// thread. So the GEMMs tile
// 128 x 128 (or 128 x C for LayerNorm) over all B*L rows and pass their
// intermediates through device memory (~0.2 GB at B=2). The six weights
// are split once a call (split_weights_kernel), so no block splits a
// weight; each 32-column K stage of A arrives by cp.async and is split in
// place in shared memory, beside the split W tiles. What holds it back:
// a stage's split, 12 wgmma and wait run in series (a third stage moved
// nothing measurable on the card), both 3xTF32
// operands come from shared memory, the intermediates' round trips, and
// the CUDA-core kv and message kernels (~20 % of the route's time).
#include "common.cuh"
#include "hopper.cuh"

using namespace far;

namespace {

enum Epi { EPI_NONE = 0, EPI_ELU1 = 1, EPI_DIV = 2, EPI_RELU = 3, EPI_LN = 4 };

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
  // KV rounds to the storage type where the TPU kernel casts it (:72);
  // sum(k) stays f32
  for (int e = threadIdx.x; e < H * nel; e += NT) {
    const float a = kv[(size_t)b * H * nel + e];
    kvs[e] = e % nel < d * d ? rnd<T>(a) : a;
  }
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

// CUDA-core route: float32, and the bfloat16 shapes outside
// FAR_K1_TC_SHAPES. x (B, L, C), src (B, S, C); wq/wk/wv/wm (C, C), w0
// (2C, 2C), w1 (C, 2C) torch Linear weights in the storage type; ln1/ln2
// (2, C) float32 [weight; bias]. dtype: 0 = float32, 1 = bfloat16 (every
// product accumulates in f32; q, k, v, KV, msg, m, y and out round to
// bf16 where the TPU kernel casts them).
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

// ---------------------------------------------------------------------------
// bfloat16 route on the tensor cores (see the note at the top).
// ---------------------------------------------------------------------------
namespace tc {

using bf = __nv_bfloat16;
using namespace far::hopper;

constexpr int THREADS = 256;  // two warpgroups
constexpr int ROWS = 128;     // x rows of a row-pass block
constexpr int CHUNK = 64;     // src rows of a kv-pass block

template <int C, int DH>
struct Shape {
  static constexpr int H = C / DH;
  static constexpr int KA = C / 64;                   // 64-wide K atoms of a C-wide operand
  static constexpr int NP = C % 128 == 0 ? 128 : 64;  // wgmma N of a full-width piece
  static constexpr int NPC = C / NP;
  static constexpr int NYC = 2 * C / 64;              // 64-column chunks of y
  static constexpr int TILE = C * 128;                // bytes of one streamed weight tile
  static constexpr int TILES = 2 * KA + 1 + 3 * NYC;
  static constexpr int NEL = DH * DH + DH;            // per-head KV and sum(k)
  static constexpr int XS = ROWS * C * 2;
  static constexpr int SMEM_ROW = 2 * XS + 2 * TILE + 5 * C * 4 + 1024;
  static constexpr int SRC = CHUNK * C * 2;
  static constexpr int W = ROWS * C * 2;              // 128 rows of Wk (or Wv)
  static constexpr int SMEM_KV = SRC + 2 * W + 2 * 64 * 128 + 1024;
  static_assert(C % 64 == 0 && C <= 256 && 64 % DH == 0 && DH % 8 == 0, "unsupported shape");
};

// (a) Grid (ceil(S / CHUNK), B). part: (B, nchunk, H, DH*DH + DH).
template <int C, int DH>
__global__ void __launch_bounds__(THREADS, 1)
kv_pass_kernel(const bf* __restrict__ src, const bf* __restrict__ wk, const bf* __restrict__ wv,
               int S, float* __restrict__ part) {
  using Sh = Shape<C, DH>;
  extern __shared__ char smem_raw[];
  char* sm = align1024(smem_raw);
  char* srcs = sm;               // CHUNK x C
  char* wks = sm + Sh::SRC;      // 128 rows (two 64-feature groups) x C
  char* wvs = wks + Sh::W;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane & 3);
  char* vts = wvs + Sh::W + wg * 64 * 128;  // v^T of one group: 64 features x CHUNK rows
  const int b = blockIdx.y, chunk = blockIdx.x, s0 = chunk * CHUNK, vrows = S - s0;
  float* pb = part + ((size_t)b * gridDim.x + chunk) * Sh::H * Sh::NEL;
  const float inv_s = 1.f / (float)S;
  load_tile(srcs, src + ((size_t)b * S + s0) * C, C, CHUNK, Sh::KA, vrows, C, tid, THREADS);

  for (int g0 = 0; g0 < Sh::KA; g0 += 2) {
    if (g0 > 0) __syncthreads();  // the previous groups' reads of wks / wvs are done
    load_tile(wks, wk + (size_t)64 * g0 * C, C, ROWS, Sh::KA, C - 64 * g0, C, tid, THREADS);
    load_tile(wvs, wv + (size_t)64 * g0 * C, C, ROWS, Sh::KA, C - 64 * g0, C, tid, THREADS);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    const int g = g0 + wg;
    if (g >= Sh::KA) continue;
    // k^T, v^T (64 features x CHUNK src rows) = W[group rows] . src^T
    float ka[32], va[32];
    wg_fence();
    for (int a = 0; a < Sh::KA; ++a) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t db = desc(srcs + a * CHUNK * 128 + ks * 32);
        const int off = a * ROWS * 128 + wg * 64 * 128 + ks * 32;
        wgmma_ss(ka, desc(wks + off), db, (a | ks) != 0);
        wgmma_ss(va, desc(wvs + off), db, (a | ks) != 0);
      }
    }
    wg_commit();
    wg_wait<0>();
    keep(ka);
    keep(va);
    float ksum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int n = 8 * (e >> 2) + c0 + (e & 1);
      const float kv = n < vrows ? rnd<bf>(elu1(ka[e])) : 0.f;
      ka[e] = kv;
      ksum[(e >> 1) & 1] += kv;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *(uint32_t*)(vts + swz(64, r0 + 8 * h, 8 * j + c0)) =
            pack_bf16(va[4 * j + 2 * h] * inv_s, va[4 * j + 2 * h + 1] * inv_s);
    fence_async_smem();
    wg_barrier(wg);
    uint32_t kA[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) frag(ka, kb, kA[kb]);
    float kv[32];
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) wgmma_rs(kv, kA[kb], desc(vts + kb * 32), kb != 0);
    wg_commit();
    wg_wait<0>();
    keep(kv);
    keep(kA);
    // the diagonal (head) blocks of this group's 64 x 64 k^T v
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = 64 * g + r0 + 8 * ((e >> 1) & 1);
      const int j = 64 * g + 8 * (e >> 2) + c0 + (e & 1);
      if (i / DH == j / DH) pb[(i / DH) * Sh::NEL + (i % DH) * DH + j % DH] = kv[e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s = quad_sum(ksum[h]);
      const int i = 64 * g + r0 + 8 * h;
      if (c0 == 0) pb[(i / DH) * Sh::NEL + DH * DH + i % DH] = s;
    }
  }
}

// (b) kvbd (B, 64, C) bf16: row n, column 64g + k holds KV_h[k'][n'] of
// head h when feature 64g + k and output column 64g + n both lie in head
// h (k', n' their offsets in it), else 0 - group g's B operand.
// ksum (B, C) f32. Chunks are summed in order.
template <int C, int DH>
__global__ void kv_reduce_tc_kernel(const float* __restrict__ part, int B, int nchunk,
                                    bf* __restrict__ kvbd, float* __restrict__ ksum) {
  using Sh = Shape<C, DH>;
  const int per_b = 64 * C + C;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * per_b) return;
  const int b = i / per_b, e = i % per_b;
  const float* pb = part + (size_t)b * nchunk * Sh::H * Sh::NEL;
  float s = 0.f;
  if (e < 64 * C) {
    const int nn = e / C, k = e % C, n = (k / 64) * 64 + nn;
    if (n / DH == k / DH) {
      const int o = (n / DH) * Sh::NEL + (k % DH) * DH + n % DH;
      for (int t = 0; t < nchunk; ++t) s += pb[(size_t)t * Sh::H * Sh::NEL + o];
    }
    kvbd[(size_t)b * 64 * C + e] = __float2bfloat16_rn(s);
  } else {
    const int c = e - 64 * C, o = (c / DH) * Sh::NEL + DH * DH + c % DH;
    for (int t = 0; t < nchunk; ++t) s += pb[(size_t)t * Sh::H * Sh::NEL + o];
    ksum[(size_t)b * C + c] = s;
  }
}

// (c) Grid (ceil(L / ROWS), B).
template <int C, int DH>
__global__ void __launch_bounds__(THREADS, 1)
row_pass_kernel(const bf* __restrict__ x, const bf* __restrict__ wq, const bf* __restrict__ wm,
                const bf* __restrict__ w0, const bf* __restrict__ w1,
                const bf* __restrict__ kvbd, const float* __restrict__ ksum_g,
                const float* __restrict__ ln1, const float* __restrict__ ln2, int L, int S,
                bf* __restrict__ out) {
  using Sh = Shape<C, DH>;
  constexpr int KA = Sh::KA, NP = Sh::NP, NPC = Sh::NPC, H = Sh::H;
  extern __shared__ char smem_raw[];
  char* sm = align1024(smem_raw);
  char* xs = sm;                    // ROWS x C: KA atoms of ROWS rows
  char* ms = sm + Sh::XS;           // per warpgroup KA atoms of 64 rows: msg, then m
  char* stg = ms + Sh::XS;          // two weight stages
  float* lnp = (float*)(stg + 2 * Sh::TILE);  // ln1 (2, C), ln2 (2, C)
  float* ks = lnp + 4 * C;                    // sum(k)
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane & 3);
  const int b = blockIdx.y, row0 = blockIdx.x * ROWS, vrows = L - row0;
  const char* xw = xs + wg * 64 * 128;  // this warpgroup's rows in each x atom
  char* mw = ms + wg * 64 * C * 2;

  for (int i = tid; i < 2 * C; i += THREADS) {
    lnp[i] = ln1[i];
    lnp[2 * C + i] = ln2[i];
  }
  for (int i = tid; i < C; i += THREADS) ks[i] = ksum_g[(size_t)b * C + i];
  load_tile(xs, x + ((size_t)b * L + row0) * C, C, ROWS, KA, vrows, C, tid, THREADS);

  // The weight stream: tile t goes to stage t % 2.
  auto issue = [&](int t) {
    const bf* g;
    int ld = C, rows = C, atoms = 1;
    if (t < KA) {
      g = wq + 64 * t;
    } else if (t == KA) {
      g = kvbd + (size_t)b * 64 * C, rows = 64, atoms = KA;
    } else if (t < 2 * KA + 1) {
      g = wm + 64 * (t - KA - 1);
    } else {
      const int u = t - 2 * KA - 1, c = u / 3, part = u % 3;
      ld = 2 * C;
      if (part < 2)
        g = w0 + (size_t)64 * c * 2 * C + part * C, rows = 64, atoms = KA;
      else
        g = w1 + 64 * c;
    }
    load_tile(stg + (t & 1) * Sh::TILE, g, ld, rows, atoms, rows, 64 * atoms, tid, THREADS);
  };
  int t = 0;
  issue(0);
  cp_async_commit();
  auto acquire = [&]() -> const char* {
    if (t + 1 < Sh::TILES) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    return stg + (t & 1) * Sh::TILE;
  };
  auto release = [&]() {
    __syncthreads();
    ++t;
  };

  // q = elu(x Wq^T) + 1
  float acc[NPC][NP / 2];
  for (int a = 0; a < KA; ++a) {
    const char* tl = acquire();
    wg_fence();
#pragma unroll
    for (int ks4 = 0; ks4 < 4; ++ks4) {
      const uint64_t da = desc(xw + a * ROWS * 128 + ks4 * 32);
#pragma unroll
      for (int p = 0; p < NPC; ++p)
        wgmma_ss(acc[p], da, desc(tl + p * NP * 128 + ks4 * 32), (a | ks4) != 0);
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NPC; ++p) keep(acc[p]);
    release();
  }
  float z[2][H];
  uint32_t qA[C / 16][4];
  {
    float den[2][H];
#pragma unroll
    for (int h = 0; h < H; ++h) den[0][h] = den[1][h] = 0.f;
#pragma unroll
    for (int p = 0; p < NPC; ++p)
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) {
        const int cb = p * NP + 8 * (e >> 2);
        const float q = rnd<bf>(elu1(acc[p][e]));
        acc[p][e] = q;
        den[(e >> 1) & 1][cb / DH] += q * ks[cb + c0 + (e & 1)];
      }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      z[0][h] = 1.f / (quad_sum(den[0][h]) + 1e-6f) * (float)S;
      z[1][h] = 1.f / (quad_sum(den[1][h]) + 1e-6f) * (float)S;
    }
#pragma unroll
    for (int kb = 0; kb < C / 16; ++kb) frag(acc[kb * 16 / NP], (kb * 16 % NP) / 16, qA[kb]);
  }

  // msg = (q KV) Z S, one 64-column group (whole heads) at a time
  {
    const char* tl = acquire();
#pragma unroll
    for (int g = 0; g < KA; ++g) {
      float mg[32];
      wg_fence();
#pragma unroll
      for (int ks4 = 0; ks4 < 4; ++ks4)
        wgmma_rs(mg, qA[4 * g + ks4], desc(tl + g * 64 * 128 + ks4 * 32), ks4 != 0);
      wg_commit();
      wg_wait<0>();
      keep(mg);
      keep(qA);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float zz = z[h][(64 * g + 8 * j) / DH];
          *(uint32_t*)(mw + swz(64, r0 + 8 * h, 64 * g + 8 * j + c0)) =
              pack_bf16(mg[4 * j + 2 * h] * zz, mg[4 * j + 2 * h + 1] * zz);
        }
    }
    release();
  }

  // m = LN1(msg Wm^T)
  for (int a = 0; a < KA; ++a) {
    const char* tl = acquire();
    wg_fence();
#pragma unroll
    for (int ks4 = 0; ks4 < 4; ++ks4) {
      const uint64_t da = desc(mw + a * 64 * 128 + ks4 * 32);
#pragma unroll
      for (int p = 0; p < NPC; ++p)
        wgmma_ss(acc[p], da, desc(tl + p * NP * 128 + ks4 * 32), (a | ks4) != 0);
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NPC; ++p) keep(acc[p]);
    release();
  }
  {
    float mu[2], rstd[2];
    acc_row_stats(acc, mu, rstd, C);
#pragma unroll
    for (int p = 0; p < NPC; ++p)
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = p * NP + 8 * j + c0;
          const float a0 = (acc[p][4 * j + 2 * h] - mu[h]) * rstd[h] * lnp[col] + lnp[C + col];
          const float a1 =
              (acc[p][4 * j + 2 * h + 1] - mu[h]) * rstd[h] * lnp[col + 1] + lnp[C + col + 1];
          *(uint32_t*)(mw + swz(64, r0 + 8 * h, col)) = pack_bf16(a0, a1);
        }
  }

  // out_pre = relu(x W0x^T + m W0m^T) W1^T, 64 columns of y at a time
  for (int c = 0; c < Sh::NYC; ++c) {
    float ya[32];
    for (int half = 0; half < 2; ++half) {
      const char* tl = acquire();
      const char* aw = half == 0 ? xw : mw;
      const int astride = half == 0 ? ROWS * 128 : 64 * 128;
      wg_fence();
#pragma unroll
      for (int a = 0; a < KA; ++a)
#pragma unroll
        for (int ks4 = 0; ks4 < 4; ++ks4)
          wgmma_ss(ya, desc(aw + a * astride + ks4 * 32), desc(tl + a * 64 * 128 + ks4 * 32),
                   (half | a | ks4) != 0);
      wg_commit();
      wg_wait<0>();
      keep(ya);
      release();
    }
    uint32_t yA[4][4];
#pragma unroll
    for (int e = 0; e < 32; ++e) ya[e] = fmaxf(ya[e], 0.f);
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) frag(ya, kb, yA[kb]);
    const char* tl = acquire();
#pragma unroll
    for (int p = 0; p < NPC; ++p) keep(acc[p]);
    wg_fence();
#pragma unroll
    for (int ks4 = 0; ks4 < 4; ++ks4)
#pragma unroll
      for (int p = 0; p < NPC; ++p)
        wgmma_rs(acc[p], yA[ks4], desc(tl + p * NP * 128 + ks4 * 32), (c | ks4) != 0);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NPC; ++p) keep(acc[p]);
    keep(yA);
    release();
  }

  // out = x + LN2(out_pre)
  float mu[2], rstd[2];
  acc_row_stats(acc, mu, rstd, C);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * wg + r0 + 8 * h;
    if (row >= vrows) continue;
    bf* orow = out + ((size_t)b * L + row0 + row) * C;
#pragma unroll
    for (int p = 0; p < NPC; ++p)
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int col = p * NP + 8 * j + c0;
        const __nv_bfloat162 xv = *(const __nv_bfloat162*)(xs + swz(ROWS, row, col));
        const float l2w0 = lnp[2 * C + col], l2w1 = lnp[2 * C + col + 1];
        const float l2b0 = lnp[3 * C + col], l2b1 = lnp[3 * C + col + 1];
        const float a0 = __low2float(xv) + (acc[p][4 * j + 2 * h] - mu[h]) * rstd[h] * l2w0 + l2b0;
        const float a1 =
            __high2float(xv) + (acc[p][4 * j + 2 * h + 1] - mu[h]) * rstd[h] * l2w1 + l2b1;
        *(uint32_t*)(orow + col) = pack_bf16(a0, a1);
      }
  }
}

struct Scratch {
  float* part;
  bf* kvbd;
  float* ksum;
  size_t bytes;
};

Scratch scratch_layout(char* base, int B, int S, int C, int H) {
  const int DH = C / H, nchunk = (S + CHUNK - 1) / CHUNK;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base + off;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  Scratch s;
  s.part = (float*)take(sizeof(float) * B * nchunk * H * (DH * DH + DH));
  s.kvbd = (bf*)take(sizeof(bf) * B * 64 * C);
  s.ksum = (float*)take(sizeof(float) * B * C);
  s.bytes = off;
  return s;
}

template <int C, int DH>
int run(const bf* x, const bf* src, const bf* wq, const bf* wk, const bf* wv, const bf* wm,
        const bf* w0, const bf* w1, const float* ln1, const float* ln2, bf* out, char* scratch,
        int B, int L, int S, cudaStream_t st) {
  using Sh = Shape<C, DH>;
  Scratch s = scratch_layout(scratch, B, S, C, Sh::H);
  cudaError_t err = cudaFuncSetAttribute(kv_pass_kernel<C, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM_KV);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(row_pass_kernel<C, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM_ROW);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (S + CHUNK - 1) / CHUNK;
  kv_pass_kernel<C, DH><<<dim3(nchunk, B), THREADS, Sh::SMEM_KV, st>>>(src, wk, wv, S, s.part);
  const int n = B * (64 * C + C);
  kv_reduce_tc_kernel<C, DH><<<(n + 255) / 256, 256, 0, st>>>(s.part, B, nchunk, s.kvbd, s.ksum);
  row_pass_kernel<C, DH><<<dim3((L + ROWS - 1) / ROWS, B), THREADS, Sh::SMEM_ROW, st>>>(
      x, wq, wm, w0, w1, s.kvbd, s.ksum, ln1, ln2, L, S, out);
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" size_t far_loftr_layer_tc_scratch(int B, int S, int C, int H) {
  return tc::scratch_layout(nullptr, B, S, C, H).bytes;
}

// The (C, C / H) the bfloat16 route is built for: every shape Shape<>
// accepts (C a multiple of 64 up to 256, the head width dividing 64).
#define FAR_K1_TC_SHAPES(X)                                                      \
  X(64, 8) X(64, 16) X(64, 32) X(64, 64) X(128, 8) X(128, 16) X(128, 32)          \
  X(128, 64) X(192, 8) X(192, 16) X(192, 32) X(192, 64) X(256, 8) X(256, 16)     \
  X(256, 32) X(256, 64)

// 1 when far_loftr_layer_tc takes (C, H), else 0; the wrapper asks first.
extern "C" size_t far_loftr_layer_tc_supports(int C, int H) {
  const int DH = H > 0 && C % H == 0 ? C / H : 0;
#define FAR_K1_TC_IS(CC, DD) if (C == CC && DH == DD) return 1;
  FAR_K1_TC_SHAPES(FAR_K1_TC_IS)
#undef FAR_K1_TC_IS
  return 0;
}

// bfloat16 route: the arguments of far_loftr_layer in bf16 (ln1/ln2 stay
// float32). A shape outside FAR_K1_TC_SHAPES returns cudaErrorInvalidValue.
extern "C" int far_loftr_layer_tc(const void* x, const void* src, const void* wq, const void* wk,
                                  const void* wv, const void* wm, const void* w0, const void* w1,
                                  const void* ln1, const void* ln2, void* out, void* scratch,
                                  int B, int L, int S, int C, int H, void* stream) {
  using bf = __nv_bfloat16;
  const int DH = H > 0 && C % H == 0 ? C / H : 0;
#define FAR_K1_TC_RUN(CC, DD)                                                                 \
  if (C == CC && DH == DD)                                                                    \
    return tc::run<CC, DD>((const bf*)x, (const bf*)src, (const bf*)wq, (const bf*)wk,       \
                           (const bf*)wv, (const bf*)wm, (const bf*)w0, (const bf*)w1,       \
                           (const float*)ln1, (const float*)ln2, (bf*)out, (char*)scratch, B, \
                           L, S, (cudaStream_t)stream);
  FAR_K1_TC_SHAPES(FAR_K1_TC_RUN)
#undef FAR_K1_TC_RUN
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// float32 route on the tensor cores, 3xTF32 (see the note at the top).
// ---------------------------------------------------------------------------
namespace tf32 {

using namespace far::hopper;

constexpr int THREADS = 256;  // two warpgroups
constexpr int BM = 128;       // rows of a block (64 a warpgroup)
constexpr int KC = 32;        // K columns a stage: one atom

template <int NP>  // the block's output columns in pieces of 128
struct Tile {
  static constexpr int BN = 128 * NP;
  static constexpr int AT = BM * KC * 4;           // A: 16 KB
  static constexpr int WT = BN * KC * 4;           // W: 16 KB a piece
  static constexpr int STAGE = 2 * AT + 2 * WT;    // big and small of both
  static constexpr int SMEM = 2 * STAGE + 1024;
};

// The weights split once a call: big and small of 6 float32 matrices (n4
// float4s each, end4 the running sums) into two buffers of the same
// layout, the matrices one after another.
struct Weights {
  const float* src[6];
  int end4[6];
};

__global__ void split_weights_kernel(Weights w, float* __restrict__ big, float* __restrict__ small) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w.end4[5]) return;
  int m = 0;
  while (i >= w.end4[m]) ++m;
  const float4 v = ((const float4*)w.src[m])[i - (m > 0 ? w.end4[m - 1] : 0)];
  uint4 b, sm;
  tf32_split(v.x, b.x, sm.x);
  tf32_split(v.y, b.y, sm.y);
  tf32_split(v.z, b.z, sm.z);
  tf32_split(v.w, b.w, sm.w);
  ((uint4*)big)[i] = b;
  ((uint4*)small)[i] = sm;
}

// out (M, N) = epi(A1 W1^T + A2 W2^T), each product 3xTF32 on the tensor
// cores. A row-major (M x K, lda), W a torch Linear weight (N x K, ldw)
// given as its big and small TF32 parts (W1, W1s), both K-major as TF32
// wgmma wants them; A2 may be null. K1 and K2 are multiples of KC, N of
// the block's BN. The two stages hold big and small of an A and a W
// tile: A arrives by cp.async and is split in place, W arrives split. EPI_LN: the block spans the whole row (N == BN); out = LN(acc) *
// ln[0] + ln[1] (+ res), the statistics from the accumulators (a row
// lives in one quad). Grid (N / BN, ceil(M / BM)).
template <int NP, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_tf32_kernel(const float* __restrict__ A1, int lda1, const float* __restrict__ W1,
                 const float* __restrict__ W1s, int ldw1, int K1, const float* __restrict__ A2,
                 int lda2, const float* __restrict__ W2, const float* __restrict__ W2s, int ldw2,
                 int K2, int M, int N, float div, const float* __restrict__ ln,
                 const float* __restrict__ res, float* __restrict__ out) {
  using T = Tile<NP>;
  extern __shared__ char smem_raw[];
  char* sm = align1024(smem_raw);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane & 3);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * T::BN;
  const int n1 = K1 / KC, nk = n1 + (A2 != nullptr ? K2 / KC : 0);
  auto prefetch = [&](int t) {
    char* st = sm + (t & 1) * T::STAGE;
    const bool first = t < n1;
    const float* a = first ? A1 : A2;
    const float* w = first ? W1 : W2;
    const float* ws = first ? W1s : W2s;
    const int lda = first ? lda1 : lda2, ldw = first ? ldw1 : ldw2;
    const int kc = (first ? t : t - n1) * KC;
    const size_t wo = (size_t)col0 * ldw + kc;
    load_tile(st, a + (size_t)row0 * lda + kc, lda, BM, 1, M - row0, KC, tid, THREADS);
    load_tile(st + 2 * T::AT, w + wo, ldw, T::BN, 1, T::BN, KC, tid, THREADS);
    load_tile(st + 2 * T::AT + T::WT, ws + wo, ldw, T::BN, 1, T::BN, KC, tid, THREADS);
  };
  float acc[NP][64];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[p][e] = 0.f;
  prefetch(0);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) prefetch(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    char* st = sm + (t & 1) * T::STAGE;
    split_tile(st, st + T::AT, T::AT, tid, THREADS);
    fence_async_smem();
    __syncthreads();
    const char* ab = st + wg * 64 * 128;
    const char* as = ab + T::AT;
    const char* wb = st + 2 * T::AT;
    const char* ws = wb + T::WT;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int wo = p * 128 * 128 + kk * 32;
        wgmma_tf32_ss(acc[p], desc(as + kk * 32), desc(wb + wo), 1);
        wgmma_tf32_ss(acc[p], desc(ab + kk * 32), desc(ws + wo), 1);
        wgmma_tf32_ss(acc[p], desc(ab + kk * 32), desc(wb + wo), 1);
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) keep(acc[p]);
    __syncthreads();  // this stage is free for the load two tiles on
  }
  float mu[2] = {0.f, 0.f}, rstd[2] = {1.f, 1.f};
  if (EPI == EPI_LN) acc_row_stats(acc, mu, rstd, T::BN);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 64 * wg + r0 + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = col0 + p * 128 + 8 * j + c0;
        float a[2] = {acc[p][4 * j + 2 * h], acc[p][4 * j + 2 * h + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (EPI == EPI_ELU1) a[e] = elu1(a[e]);
          if (EPI == EPI_DIV) a[e] = a[e] / div;
          if (EPI == EPI_RELU) a[e] = fmaxf(a[e], 0.f);
          if (EPI == EPI_LN) {
            a[e] = (a[e] - mu[h]) * rstd[h] * ln[col + e] + ln[N + col + e];
            if (res != nullptr) a[e] += res[(size_t)row * N + col + e];
          }
        }
        *(float2*)(out + (size_t)row * N + col) = make_float2(a[0], a[1]);
      }
  }
}

// A weight by its big and small parts, at the same offset of the split
// buffers.
struct Split {
  const float* big;
  const float* small;
  Split at(size_t off) const { return {big + off, small + off}; }
};

template <int NP, int EPI>
int gemm(const float* A1, int lda1, Split W1, int ldw1, int K1, const float* A2, int lda2,
         Split W2, int ldw2, int K2, int M, int N, float div, const float* ln, const float* res,
         float* out, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(gemm_tf32_kernel<NP, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<NP>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / Tile<NP>::BN, (M + BM - 1) / BM);
  gemm_tf32_kernel<NP, EPI><<<grid, THREADS, Tile<NP>::SMEM, st>>>(
      A1, lda1, W1.big, W1.small, ldw1, K1, A2, lda2, W2.big, W2.small, ldw2, K2, M, N, div, ln,
      res, out);
  return (int)cudaGetLastError();
}

// Bytes of the float32 route's scratch: the CUDA-core route's layout
// (float32), then the big and small parts of the 10 C^2 weights.
size_t scratch_bytes(int B, int L, int S, int C, int H, size_t* split_off) {
  const size_t off = layout(nullptr, sizeof(float), B, L, S, C, H).bytes;
  if (split_off != nullptr) *split_off = off;
  return off + 2 * sizeof(float) * 10 * (size_t)C * C;
}

// The layer as a chain: five 3xTF32 products (q; k; v; m with LN1; y,
// whose x and m halves accumulate together; out with LN2 and the
// residual), and the per-head k^T v and q KV on the CUDA cores in float32
// (the CUDA-core route's kernels). NPL = C / 128 pieces a LayerNorm row.
template <int NPL>
int run(const float* x, const float* src, const float* wq, const float* wk, const float* wv,
        const float* wm, const float* w0, const float* w1, const float* ln1, const float* ln2,
        float* out, char* scratch, int B, int L, int S, int C, int H, cudaStream_t st) {
  const int d = C / H, nel = d * d + d;
  Layout l = layout(scratch, sizeof(float), B, L, S, C, H);
  float *q = (float*)l.q, *k = (float*)l.k, *v = (float*)l.v, *msg = (float*)l.msg,
        *m = (float*)l.m, *y = (float*)l.y;
  const int ML = B * L, MS = B * S;
  // split the weights once: wq, wk, wv, wm (C^2 each), w0 (4 C^2), w1 (2 C^2)
  size_t split_off;
  scratch_bytes(B, L, S, C, H, &split_off);
  const size_t cc = (size_t)C * C;
  float* wbig = (float*)(scratch + split_off);
  float* wsml = wbig + 10 * cc;
  const int c4 = (int)(cc / 4);
  const Weights ws{{wq, wk, wv, wm, w0, w1}, {c4, 2 * c4, 3 * c4, 4 * c4, 8 * c4, 10 * c4}};
  split_weights_kernel<<<(10 * c4 + 255) / 256, 256, 0, st>>>(ws, wbig, wsml);
  const Split W{wbig, wsml}, none{nullptr, nullptr};
  int err = gemm<1, EPI_ELU1>(x, C, W.at(0), C, C, nullptr, 0, none, 0, 0, ML, C, 1.f, nullptr,
                              nullptr, q, st);
  if (!err)
    err = gemm<1, EPI_ELU1>(src, C, W.at(cc), C, C, nullptr, 0, none, 0, 0, MS, C, 1.f, nullptr,
                            nullptr, k, st);
  if (!err)
    err = gemm<1, EPI_DIV>(src, C, W.at(2 * cc), C, C, nullptr, 0, none, 0, 0, MS, C, (float)S,
                           nullptr, nullptr, v, st);
  if (err) return err;
  const int nsplit = (S + KV_ROWS - 1) / KV_ROWS;
  kv_partial_kernel<float><<<dim3(B * H, nsplit), NT, sizeof(float) * 2 * KV_SUB * d, st>>>(
      k, v, S, C, H, l.part);
  kv_reduce_kernel<<<(B * H * nel + 255) / 256, 256, 0, st>>>(l.part, B * H, nsplit, nel, l.kv);
  const size_t msg_smem = sizeof(float) * ((size_t)H * nel + MSG_ROWS * C);
  cudaError_t cerr = cudaFuncSetAttribute(msg_kernel<float>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)msg_smem);
  if (cerr != cudaSuccess) return (int)cerr;
  msg_kernel<float><<<dim3((L + MSG_ROWS - 1) / MSG_ROWS, B), NT, msg_smem, st>>>(
      q, l.kv, L, S, C, H, msg);
  err = gemm<NPL, EPI_LN>(msg, C, W.at(3 * cc), C, C, nullptr, 0, none, 0, 0, ML, C, 1.f, ln1,
                          nullptr, m, st);
  // mlp.0 weight is (2C, 2C): its first C input columns take x, the rest m
  if (!err)
    err = gemm<1, EPI_RELU>(x, C, W.at(4 * cc), 2 * C, C, m, C, W.at(4 * cc + C), 2 * C, C, ML,
                            2 * C, 1.f, nullptr, nullptr, y, st);
  if (!err)
    err = gemm<NPL, EPI_LN>(y, 2 * C, W.at(8 * cc), 2 * C, 2 * C, nullptr, 0, none, 0, 0, ML, C,
                            1.f, ln2, x, out, st);
  return err;
}

}  // namespace tf32

// 1 when far_loftr_layer_tf32 takes (C, H): C of 128 or 256 (whole
// 128-column pieces, a LayerNorm row in one block) and a head's k^T v
// within the CUDA-core kernels' reach (d^2 + d <= 2048), else 0.
extern "C" size_t far_loftr_layer_tf32_supports(int C, int H) {
  if ((C != 128 && C != 256) || H < 1 || C % H != 0) return 0;
  const int d = C / H;
  return d * d + d <= KV_PER_THREAD * NT;
}

extern "C" size_t far_loftr_layer_tf32_scratch(int B, int L, int S, int C, int H) {
  return tf32::scratch_bytes(B, L, S, C, H, nullptr);
}

// float32 route, 3xTF32: the arguments of far_loftr_layer in float32. A
// shape far_loftr_layer_tf32_supports refuses returns cudaErrorInvalidValue.
extern "C" int far_loftr_layer_tf32(const void* x, const void* src, const void* wq,
                                    const void* wk, const void* wv, const void* wm, const void* w0,
                                    const void* w1, const void* ln1, const void* ln2, void* out,
                                    void* scratch, int B, int L, int S, int C, int H,
                                    void* stream) {
  if (!far_loftr_layer_tf32_supports(C, H)) return (int)cudaErrorInvalidValue;
  using Run = int (*)(const float*, const float*, const float*, const float*, const float*,
                      const float*, const float*, const float*, const float*, const float*,
                      float*, char*, int, int, int, int, int, cudaStream_t);
  const Run run = C == 256 ? tf32::run<2> : tf32::run<1>;
  return run((const float*)x, (const float*)src, (const float*)wq, (const float*)wk,
             (const float*)wv, (const float*)wm, (const float*)w0, (const float*)w1,
             (const float*)ln1, (const float*)ln2, (float*)out, (char*)scratch, B, L, S, C, H,
             (cudaStream_t)stream);
}
