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
// ~35 GFLOP per pair on ~26 MB of tokens in and out.
//
// CUDA-core route (far_fine_transformer; float32, and bf16 shapes outside
// FAR_K3_TC_SHAPES): one block owns wpb windows (R = wpb*s rows), holds
// both images' tokens and the layer's intermediates in shared memory as
// f32, 4 (5 R C + wpb H (d^2 + d)) bytes (about 145 KB at C=128, s=25,
// wpb=2), and streams the weights from L2 through the same 64x64 tile
// product as K1 (common.cuh). wpb is 2 where that fits the card's
// per-block limit and 1 where it does not (C >= 192 at s=25, C=128 at
// s=81), chosen at run time. Per window and head, KV = k^T v and sum(k)
// are reduced in shared memory; the message, LayerNorm and residual never
// touch device memory. Values round to the storage type where the TPU
// kernel casts them.
//
// bfloat16 route (far_fine_transformer_tc), one launch, every product on
// the tensor cores (wgmma, hopper.cuh), weights streamed through two
// cp.async stages. A block owns 128 // s whole windows of both images
// (5 at s=25: 125 rows and 3 zero rows), two warpgroups of 64 rows, and
// runs all four layer applications on them; only f0, f1, the weights and
// the outputs touch device memory. Per application:
//  - k = elu(src Wk^T)+1 into shared memory (the B operand of q k^T);
//    v^T = Wv src^T / s (features x src rows, the B operand of P v) from
//    wgmma with W as A, so no transpose is needed; q = elu(x Wq^T)+1 stays
//    in registers as bf16 A fragments.
//  - Attention in the TPU kernel's form (far_tpu/ops/fine_layer.py:106-
//    134), one head at a time: S_h = q_h k_h^T over all 128 src rows (one
//    m64n128 wgmma per 16 of the head's width), every column outside the
//    row's window zeroed (pad rows form windows of their own, so they never
//    touch real rows), den = the masked row sum = q_h . sum_w(k_h) (two
//    quad shuffles), msg_h = bf16(S_h) v_h by m64nDk16 from registers,
//    times s / (den + 1e-6).
//  - The rest is K1's row pass at this width: m = LN1(msg Wm^T) with the
//    LayerNorm in the accumulators, y = relu(x W0x^T + m W0m^T) in 64-column
//    chunks each fed straight into the W1^T accumulator, x <- x +
//    LN2(y W1^T) rounded to bf16 in place. Cross layers stay sequential:
//    f1's application reads the updated f0 tile.
// Shared memory at C=128: X0, X1, k, v^T and msg/m of 32 KB each, two
// 16 KB weight stages, 193 KB in all (one block an SM). k, v^T and msg
// could not share space: each head needs k and v^T while earlier heads'
// msg columns are written. Registers: 255 a thread, with 48 bytes spilled
// at the main shape (C=128, head width 16) and 16-52 bytes across the six
// builds (-Xptxas -v); zeroing each projection's accumulator before its
// first wgmma (which reads it) took the main shape's spill from ~870
// bytes to 48 and its time from 0.99 to 0.66 ms at B=2 on an H100. Weights:
// each application streams its 10*C^2 bf16 (320 KB at C=128) from L2, 1.28
// MB a block, 525 MB of L2 reads a call at B=2.
// What holds it back: each weight tile's chain (barrier, wgmma, wait,
// epilogue) and each head's two products run in series within a block,
// and ceil(n / 5) blocks at one an SM leave the last wave partly empty.
// Rounding to bf16 where the TPU kernel casts: q, k (:98-99), v (:100),
// the masked S (:126), msg (:134), m (:137), y (:139), x (:141); den, the
// LayerNorms and every accumulator stay f32 (the TPU kernel rounds its
// window k-sums to bf16, :128; this route takes den from the f32 S).
// Built for C in {64, 128} and a head width of 16, 32 or 64, s <= 64:
// at C = 192 or 256 the five tiles exceed an SM's shared memory.
#include "common.cuh"
#include "hopper.cuh"

using namespace far;

namespace {

constexpr int WPB_MAX = 2;  // windows per block where they fit

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

// One LoFTR encoder layer, X <- layer(X, Y), on R rows of whole windows.
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
            int C, int H, int n_layers, int cross_mask, int wpb) {
  extern __shared__ float sh[];
  __shared__ TileSmem sm;
  const int R = wpb * s;
  const int w0 = blockIdx.x * wpb, nwin = min(wpb, n - w0);
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
  const int d = C / H;
  auto smem = [&](int wpb) {
    return sizeof(float) * ((size_t)5 * wpb * s * C + (size_t)wpb * H * (d * d + d));
  };
  // dynamic shared memory a block may take beside the static TileSmem
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t limit = (size_t)optin - sizeof(TileSmem);
  int wpb = WPB_MAX;
  while (wpb > 1 && smem(wpb) > limit) --wpb;
  if (smem(wpb) > limit) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(fine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem(wpb));
  if (err != cudaSuccess) return (int)err;
  fine_kernel<T><<<(n + wpb - 1) / wpb, NT, smem(wpb), st>>>(f0, f1, w, ln, out0, out1, n, s, C,
                                                             H, n_layers, cross_mask, wpb);
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

// ---------------------------------------------------------------------------
// bfloat16 route on the tensor cores (see the note at the top).
// ---------------------------------------------------------------------------
namespace tc {

using bf = __nv_bfloat16;
using namespace far::hopper;

constexpr int THREADS = 256;  // two warpgroups of 64 rows
constexpr int ROWS = 128;     // rows of a block's window tile (whole windows + zero pad)

template <int C, int DH>
struct Shape {
  static constexpr int H = C / DH;
  static constexpr int KA = C / 64;       // 64-wide K atoms of a C-wide operand
  static constexpr int NYC = 2 * C / 64;  // 64-column chunks of y
  static constexpr int TILE = C * 128;    // bytes of one streamed weight tile
  static constexpr int TPA = 10 * KA;     // weight tiles of one layer application
  static constexpr int XS = ROWS * C * 2; // one 128-row bf16 tile
  // X0, X1, k, v^T, msg/m, two weight stages
  static constexpr int SMEM = 5 * XS + 2 * TILE + 1024;
  static_assert((C == 64 || C == 128) && (DH == 16 || DH == 32 || DH == 64), "unsupported shape");
};

// acc (+)= A W^T over one streamed 64-column slab k of W (tile tl).
template <int N>
__device__ __forceinline__ void slab_product(float (&acc)[N], const char* a, int astride,
                                             const char* tl, int k) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(acc, desc(a + k * astride + kk * 32), desc(tl + kk * 32), (k | kk) != 0);
  wg_commit();
  wg_wait<0>();
  keep(acc);
}

// Grid ceil(n / (ROWS / s)). w: per layer [wq wk wv wm | w0 | w1] bf16
// (torch Linear layout), ln: per layer [ln1; ln2] (4, C) float32.
template <int C, int DH>
__global__ void __launch_bounds__(THREADS, 1)
fine_tc_kernel(const bf* __restrict__ f0, const bf* __restrict__ f1, const bf* __restrict__ w,
               const float* __restrict__ ln, bf* __restrict__ out0, bf* __restrict__ out1, int n,
               int s, int n_layers, int cross_mask) {
  using Sh = Shape<C, DH>;
  constexpr int KA = Sh::KA, H = Sh::H;
  extern __shared__ char smem_raw[];
  char* sm = align1024(smem_raw);
  char* xs[2] = {sm, sm + Sh::XS};     // both images' windows, 128 rows x C
  char* ks = sm + 2 * Sh::XS;          // k: 128 src rows x C (B of q k^T)
  char* vts = sm + 3 * Sh::XS;         // v^T: C features x 128 src rows (B of P v)
  char* ms = sm + 4 * Sh::XS;          // per warpgroup 64 rows x C: msg, then m
  char* stg = sm + 5 * Sh::XS;         // two weight stages
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane & 3);
  char* mw = ms + wg * 64 * C * 2;
  const int wpb = ROWS / s, w0i = blockIdx.x * wpb;
  const int vrows = min(wpb, n - w0i) * s;
  const size_t base = (size_t)w0i * s * C;
  // the first column of each of this thread's two rows' windows
  int lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lo[h] = ((64 * wg + r0 + 8 * h) / s) * s;
  const float inv_s = 1.f / (float)s;

  load_tile(xs[0], f0 + base, C, ROWS, KA, vrows, C, tid, THREADS);
  load_tile(xs[1], f1 + base, C, ROWS, KA, vrows, C, tid, THREADS);
  const int total = 2 * n_layers * Sh::TPA;
  // The weight stream: tile t goes to stage t % 2.
  auto issue = [&](int t) {
    const int u = t % Sh::TPA;
    const bf* wl = w + (size_t)(t / Sh::TPA / 2) * 10 * C * C;
    const bf* g;
    int ld = C, rows = C, atoms = 1;
    if (u < 4 * KA) {  // Wk, Wv, Wq, Wm: 64-column slabs
      g = wl + (size_t)(u / KA == 0 ? 1 : u / KA == 1 ? 2 : u / KA == 2 ? 0 : 3) * C * C +
          64 * (u % KA);
    } else {
      const int v = u - 4 * KA, c = v / 3, part = v % 3;
      ld = 2 * C;
      if (part < 2)  // rows 64c.. of mlp.0, its x or its m half
        g = wl + (size_t)4 * C * C + (size_t)64 * c * 2 * C + part * C, rows = 64, atoms = KA;
      else  // columns 64c.. of mlp.2
        g = wl + (size_t)8 * C * C + 64 * c;
    }
    load_tile(stg + (t & 1) * Sh::TILE, g, ld, rows, atoms, rows, 64 * atoms, tid, THREADS);
  };
  int t = 0;
  issue(0);
  cp_async_commit();
  auto acquire = [&]() -> const char* {
    if (t + 1 < total) issue(t + 1);
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
  // acc = A W^T over KA streamed 64-column slabs of W, A = KA atoms at a
  float accp[1][C / 2];
  float(&acc)[C / 2] = accp[0];
// (acc is zeroed first: wgmma reads its accumulator operand, so without
// that acc would stay live, and spill, through the attention)
#define FAR_K3_PROJECT(A, STRIDE)                       \
  _Pragma("unroll") for (int e_ = 0; e_ < C / 2; ++e_) acc[e_] = 0.f; \
  for (int k_ = 0; k_ < KA; ++k_) {                     \
    const char* tl_ = acquire();                        \
    slab_product(acc, (A), (STRIDE), tl_, k_);          \
    release();                                          \
  }

  for (int app = 0; app < 2 * n_layers; ++app) {
    const int li = app >> 1, img = app & 1;
    char* xt = xs[img];
    const char* yt = (cross_mask >> li) & 1 ? xs[img ^ 1] : xt;
    const char* xw = xt + wg * 64 * 128;
    const float* lnl = ln + (size_t)li * 4 * C;

    // k = elu(src Wk^T) + 1 -> ks (this warpgroup's 64 src rows)
    FAR_K3_PROJECT(yt + wg * 64 * 128, ROWS * 128)
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *(uint32_t*)(ks + swz(ROWS, 64 * wg + r0 + 8 * h, 8 * j + c0)) =
            pack_bf16(elu1(acc[4 * j + 2 * h]), elu1(acc[4 * j + 2 * h + 1]));
    // v^T = Wv src^T / s: warpgroup g owns features 64g.. (at C = 64 both
    // compute the one group and the first stores it)
    {
      const int g = C == 128 ? wg : 0;
      float va[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) va[e] = 0.f;
      for (int k = 0; k < KA; ++k) {
        const char* tl = acquire();
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(va, desc(tl + g * 64 * 128 + kk * 32), desc(yt + k * ROWS * 128 + kk * 32),
                   (k | kk) != 0);
        wg_commit();
        wg_wait<0>();
        keep(va);
        release();
      }
      if (C == 128 || wg == 0)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *(uint32_t*)(vts + swz(C, 64 * g + r0 + 8 * h, 8 * j + c0)) =
                pack_bf16(va[4 * j + 2 * h] * inv_s, va[4 * j + 2 * h + 1] * inv_s);
    }
    fence_async_smem();  // k and v^T reach wgmma after the next barrier

    // q = elu(x Wq^T) + 1, bf16 A fragments
    FAR_K3_PROJECT(xw, ROWS * 128)
    uint32_t qA[C / 16][4];
#pragma unroll
    for (int e = 0; e < C / 2; ++e) acc[e] = rnd<bf>(elu1(acc[e]));
#pragma unroll
    for (int kb = 0; kb < C / 16; ++kb) frag(acc, kb, qA[kb]);

    // per head: S_h = q_h k_h^T masked to the row's window, den = its row
    // sum, msg_h = bf16(S_h) v_h * s / (den + 1e-6)
#pragma unroll 1
    for (int hh = 0; hh < H; ++hh) {
      float sa[64];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int kb = hh * DH / 16 + kk;
        wgmma_rs(sa, qA[kb], desc(ks + (kb >> 2) * ROWS * 128 + (kb & 3) * 32), kk != 0);
      }
      wg_commit();
      wg_wait<0>();
      keep(sa);
      keep(qA);
      float den[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int h = (e >> 1) & 1, c = 8 * (e >> 2) + c0 + (e & 1);
        const float v = (unsigned)(c - lo[h]) < (unsigned)s ? sa[e] : 0.f;
        sa[e] = v;
        den[h] += v;
      }
      float z[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) z[h] = 1.f / (quad_sum(den[h]) + 1e-6f) * (float)s;
      uint32_t pA[8][4];
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) frag(sa, kb, pA[kb]);
      float mg[DH / 2];
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < 8; ++kb)
        wgmma_rs(mg, pA[kb], desc(vts + (kb >> 2) * C * 128 + hh * DH * 128 + (kb & 3) * 32),
                 kb != 0);
      wg_commit();
      wg_wait<0>();
      keep(mg);
      keep(pA);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *(uint32_t*)(mw + swz(64, r0 + 8 * h, hh * DH + 8 * j + c0)) =
              pack_bf16(mg[4 * j + 2 * h] * z[h], mg[4 * j + 2 * h + 1] * z[h]);
    }
    fence_async_smem();

    // m = LN1(msg Wm^T), over msg
    FAR_K3_PROJECT(mw, 64 * 128)
    {
      float mu[2], rstd[2];
      acc_row_stats(accp, mu, rstd, C);
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * j + c0;
          const float a0 = (acc[4 * j + 2 * h] - mu[h]) * rstd[h] * __ldg(lnl + col) + __ldg(lnl + C + col);
          const float a1 = (acc[4 * j + 2 * h + 1] - mu[h]) * rstd[h] * __ldg(lnl + col + 1) +
                           __ldg(lnl + C + col + 1);
          *(uint32_t*)(mw + swz(64, r0 + 8 * h, col)) = pack_bf16(a0, a1);
        }
    }
    fence_async_smem();

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
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(ya, desc(aw + a * astride + kk * 32), desc(tl + a * 64 * 128 + kk * 32),
                     (half | a | kk) != 0);
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
      keep(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, yA[kk], desc(tl + kk * 32), (c | kk) != 0);
      wg_commit();
      wg_wait<0>();
      keep(acc);
      keep(yA);
      release();
    }

    // x = x + LN2(out_pre), rounded to bf16 in place
    {
      float mu[2], rstd[2];
      acc_row_stats(accp, mu, rstd, C);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * wg + r0 + 8 * h;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int col = 8 * j + c0;
          uint32_t* px = (uint32_t*)(xt + swz(ROWS, row, col));
          const __nv_bfloat162 xv = *(const __nv_bfloat162*)px;
          const float a0 = __low2float(xv) + (acc[4 * j + 2 * h] - mu[h]) * rstd[h] *
                                                 __ldg(lnl + 2 * C + col) + __ldg(lnl + 3 * C + col);
          const float a1 = __high2float(xv) + (acc[4 * j + 2 * h + 1] - mu[h]) * rstd[h] *
                                                  __ldg(lnl + 2 * C + col + 1) +
                           __ldg(lnl + 3 * C + col + 1);
          *px = pack_bf16(a0, a1);
        }
      }
    }
    fence_async_smem();
  }

#undef FAR_K3_PROJECT
  __syncthreads();
  for (int i = tid; i < vrows * (C / 8); i += THREADS) {
    const int r = i / (C / 8), col = (i % (C / 8)) * 8;
    *(uint4*)(out0 + base + (size_t)r * C + col) = *(const uint4*)(xs[0] + swz(ROWS, r, col));
    *(uint4*)(out1 + base + (size_t)r * C + col) = *(const uint4*)(xs[1] + swz(ROWS, r, col));
  }
}

template <int C, int DH>
int run(const bf* f0, const bf* f1, const bf* w, const float* ln, bf* out0, bf* out1, int n,
        int s, int n_layers, int cross_mask, cudaStream_t st) {
  using Sh = Shape<C, DH>;
  cudaError_t err = cudaFuncSetAttribute(fine_tc_kernel<C, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int wpb = ROWS / s;
  fine_tc_kernel<C, DH><<<(n + wpb - 1) / wpb, THREADS, Sh::SMEM, st>>>(
      f0, f1, w, ln, out0, out1, n, s, n_layers, cross_mask);
  return (int)cudaGetLastError();
}

}  // namespace tc

// The (C, C / H) the bfloat16 route is built for; it takes windows of
// s <= 64 tokens.
#define FAR_K3_TC_SHAPES(X) X(64, 16) X(64, 32) X(64, 64) X(128, 16) X(128, 32) X(128, 64)

// 1 when far_fine_transformer_tc takes (C, H, s), else 0; the wrapper asks
// first and sends other bf16 shapes to the CUDA-core route.
extern "C" size_t far_fine_transformer_tc_supports(int C, int H, int s) {
  const int DH = H > 0 && C % H == 0 ? C / H : 0;
  if (s < 1 || s > 64) return 0;
#define FAR_K3_TC_IS(CC, DD) if (C == CC && DH == DD) return 1;
  FAR_K3_TC_SHAPES(FAR_K3_TC_IS)
#undef FAR_K3_TC_IS
  return 0;
}

// bfloat16 route: the arguments of far_fine_transformer, all bf16 but ln
// (float32). A shape outside FAR_K3_TC_SHAPES returns cudaErrorInvalidValue.
extern "C" int far_fine_transformer_tc(const void* f0, const void* f1, const void* w,
                                       const void* ln, void* out0, void* out1, int n, int s,
                                       int C, int H, int n_layers, int cross_mask,
                                       void* stream) {
  using bf = __nv_bfloat16;
  if (!far_fine_transformer_tc_supports(C, H, s) || n < 1 || n_layers < 1 || n_layers > 30)
    return (int)cudaErrorInvalidValue;
  const int DH = C / H;
#define FAR_K3_TC_RUN(CC, DD)                                                              \
  if (C == CC && DH == DD)                                                                 \
    return tc::run<CC, DD>((const bf*)f0, (const bf*)f1, (const bf*)w, (const float*)ln,  \
                           (bf*)out0, (bf*)out1, n, s, n_layers, cross_mask,               \
                           (cudaStream_t)stream);
  FAR_K3_TC_SHAPES(FAR_K3_TC_RUN)
#undef FAR_K3_TC_RUN
  return (int)cudaErrorInvalidValue;
}
