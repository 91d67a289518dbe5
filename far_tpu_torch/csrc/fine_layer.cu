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
// CUDA-core route (far_fine_transformer; float32 shapes the 3xTF32 route
// refuses, and bf16 shapes outside FAR_K3_TC_SHAPES): one block owns wpb windows (R = wpb*s rows), holds
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
//
// float32 route (far_fine_transformer_tf32), 3xTF32 on the tensor cores,
// one launch beside a small one that lays the weights out: every product
// of the projections and the MLP is three TF32 wgmma products of split
// operands, small.big + big.small + big.big (hopper.cuh; ops/tf32.py
// models it), so it keeps float32 accuracy. The bf16 route's layout does
// not fit in float32 (X0, X1, k, v^T and msg at 128 rows would take 320 KB
// of the 227 KB a block may have), so a block is one warpgroup on a
// 64-row tile: 64 // s whole windows (2 at s = 25) and zero rows after
// them, which form windows of their own. Shared memory at the main shape
// (C = 128, head width 16): X0 and X1 in float32 (64 KB), k then q then m
// and v then msg (64 KB), the windows' per-head KV and sum(k) (17 KB), two
// 32 KB weight stages: 210 KB, one block an SM.
//  - Weights: prep_weights_kernel writes, once a call, each application's
//    40 weight tiles (128 x 32 or 64 x 64) in the order the kernel takes
//    them, already split into big and small and laid out as wgmma reads
//    them in shared memory (K-major, 128-byte swizzle), mlp.2's K order
//    permuted for the register fragments of y. One thread moves a tile
//    with one cp.async.bulk whose bytes land on a stage's mbarrier, a tile
//    ahead of its products.
//  - A operands (x, src, msg, m; 64 rows, K = C) are read from shared
//    memory as TF32 register fragments and split as they are read; a warp
//    reads only the 16 rows its lanes write, so only the window passes need
//    block barriers (a write-back that a projection reads with none between
//    ends in a __syncwarp), and each k8 step's three products are a commit
//    group of their own, so the next step's fragments are read while they
//    run.
//    y = relu(x W0x^T + m W0m^T) is made 64 columns at a time and each
//    chunk, split in registers (frag_tf32), goes straight into the
//    accumulator of y W1^T. The LayerNorms run in the accumulators (a
//    row lives in one quad).
//  - Window attention (~2.4 % of the operations) on the CUDA cores in
//    float32, as K1's float32 route: per (window, head) KV = k_h^T v_h and
//    sum(k_h), then msg = q_h KV_h s / (q_h . sum(k_h) + 1e-6), with v
//    scaled by 1/s as the TPU kernel does (:100, :130); zero rows past the
//    block's windows get msg = 0.
//  - Cross layers stay sequential: f1's application reads the updated f0.
// What holds it back (cycle counts on an H100, PERF.md): the one warpgroup
// runs each tile's fragment splits, 12 wgmma and wait in series (about half
// a block's time), and the window passes and epilogues run with one warp a
// scheduler and no tensor-core work beside them (about a third). Waiting
// for weight tiles is a few per cent; streaming them unsplit and splitting
// each tile in shared memory halves the bytes but was slower.
// Built for C = 128, head widths 16 and 32, 22 <= s <= 64 (at most 2
// windows a block: a third window's KV would not fit).
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

// ---------------------------------------------------------------------------
// float32 route on the tensor cores, 3xTF32 (see the note at the top).
// ---------------------------------------------------------------------------
namespace tf32 {

using namespace far::hopper;

constexpr int THREADS = 128;        // one warpgroup
constexpr int ROWS = 64;            // rows of a block's tile: whole windows + zero rows
constexpr int WPB = 2;              // most windows a block (s >= 22)
constexpr int C = 128;              // the width the route is built for
constexpr int XS = ROWS * C * 4;    // one 64-row float32 tile, 32 KB
constexpr int TILE = 128 * 32 * 4;  // one weight tile (128 x 32 or 64 x 64), 16 KB
constexpr int TPA = 40;             // weight tiles of one layer application
constexpr int SMEM_MAX = 232448;    // shared memory a block may take on an H100 (227 KB)

constexpr int NR = 2;               // weight stages
constexpr int STAGE = 2 * TILE;     // a stage: a tile's big part, then its small part

// floats of one window's per-head KV (d x d) and sum(k) (d), with 4 floats
// of pad so that neighbouring windows start on other banks
template <int DH>
constexpr int KVW = (C / DH) * (DH * DH + DH) + 4;

// alignment, stages, X0, X1, k/q/m, v/msg, KV, mbarriers
template <int DH>
constexpr int SMEM = 1024 + NR * STAGE + 4 * XS + WPB * KVW<DH> * 4 + 64;
static_assert(SMEM<16> <= SMEM_MAX && SMEM<32> <= SMEM_MAX, "shared memory");

__device__ __forceinline__ float ld4(const char* t, int r, int c) {
  return *(const float*)(t + swz4(ROWS, r, c));
}

// The split A fragment of the k8 step whose column is k = 8 kb + t % 4, read
// from a 64-row float32 tile: rows r and r + 8, columns k and k + 4.
__device__ __forceinline__ void a_frag(const char* t, int r, int k, uint32_t (&b)[4],
                                       uint32_t (&s)[4]) {
  tf32_split(ld4(t, r, k), b[0], s[0]);
  tf32_split(ld4(t, r + 8, k), b[1], s[1]);
  tf32_split(ld4(t, r, k + 4), b[2], s[2]);
  tf32_split(ld4(t, r + 8, k + 4), b[3], s[3]);
}

// acc += a w^T over one k8 step as three TF32 products: small.big,
// big.small, big.big (wb, ws: the step's B descriptors' tiles).
template <int N>
__device__ __forceinline__ void mma3(float (&acc)[N], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const char* wb, const char* ws) {
  wgmma_tf32_rs(acc, as, desc(wb), 1);
  wgmma_tf32_rs(acc, ab, desc(ws), 1);
  wgmma_tf32_rs(acc, ab, desc(wb), 1);
}

// The stack's weights as the kernel streams them, written once a call: per
// layer the 40 tiles of an application in their order, each laid out as
// load_tile would leave it in shared memory (K-major, 128-byte swizzle, 32
// columns an atom), so that one bulk copy moves a tile. Tile u: Wk, Wv, Wq,
// Wm in 32-column slabs (u < 16, 128 x 32); then per 64-column chunk c of y,
// mlp.0's rows 64c.. over its x columns and its m columns (64 x 64, two
// tiles each) and mlp.2's columns 64c.. (128 x 32, two tiles), mlp.2's
// columns in the K order of frag_tf32 (position p of each group of 8 holds
// column 0 2 4 6 1 3 5 7 [p]). Tile t at 2 t TILE bytes: its big part,
// then its small part. One thread a float of w.
__global__ void prep_weights_kernel(const float* __restrict__ w, int n_layers,
                                    float* __restrict__ out) {
  constexpr int TF = TILE / 4;  // floats of a tile
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_layers * TPA * TF) return;
  const int li = i / (TPA * TF), u = (i / TF) % TPA, e = i % TF;
  int mat, row0 = 0, col0, ld = C, rows = 128;
  bool kperm = false;
  if (u < 16) {
    const int m = u / 4;
    mat = m == 0 ? 1 : m == 1 ? 2 : m == 2 ? 0 : 3;
    col0 = 32 * (u % 4);
  } else {
    const int c = (u - 16) / 6, part = (u - 16) % 6;
    ld = 2 * C;
    if (part < 4) {
      mat = 4, row0 = 64 * c, col0 = 64 * part, rows = 64;
    } else {
      mat = 8, col0 = 64 * c + 32 * (part - 4), kperm = true;
    }
  }
  const int byte = 4 * e, a = byte / (rows * 128), r = (byte / 128) % rows;
  int col = col0 + 32 * a + 4 * (((byte / 16) & 7) ^ (r & 7)) + (e & 3);
  if (kperm) {
    const int p = col & 7;
    col += (p < 4 ? 2 * p : 2 * p - 7) - p;
  }
  const float x = w[(size_t)li * 10 * C * C + (size_t)mat * C * C + (size_t)(row0 + r) * ld + col];
  const size_t t = (size_t)li * TPA + u;
  uint32_t b, sm;
  tf32_split(x, b, sm);
  out[2 * t * TF + e] = __uint_as_float(b);
  out[(2 * t + 1) * TF + e] = __uint_as_float(sm);
}

// Grid ceil(n / (ROWS / s)). tiles: prep_weights_kernel's output; ln: per
// layer [ln1; ln2] (4, C).
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
fine_tf32_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                 const float* __restrict__ tiles, const float* __restrict__ ln,
                 float* __restrict__ out0, float* __restrict__ out1, int n, int s,
                 int n_layers, int cross_mask) {
  constexpr int H = C / DH, NEL = DH * DH + DH;
  extern __shared__ char smem_raw[];
  char* sm = align1024(smem_raw);
  char* stg = sm;                                         // NR weight stages
  char* xs[2] = {stg + NR * STAGE, stg + NR * STAGE + XS};  // both images' windows
  char* ab = xs[1] + XS;                                  // k, then q, then m
  char* vb = ab + XS;                                     // v, then msg
  float* kv = (float*)(vb + XS);                          // per window and head: KV, sum(k)
  uint64_t* full = (uint64_t*)(kv + WPB * KVW<DH>);       // a stage's tile has landed
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane & 3), k0 = lane & 3;
  const int wpb = ROWS / s, w0i = blockIdx.x * wpb;
  const int vrows = min(wpb, n - w0i) * s;
  const size_t base = (size_t)w0i * s * C;
  const int total = 2 * n_layers * TPA;
  const float inv_s = 1.f / (float)s;  // v's scale, as far_tpu/ops/fine_layer.py:100

  // tile tt of the stream into its stage, by one thread
  auto load = [&](int tt) {
    const int sl = tt % NR;
    const size_t ti = (size_t)(tt / TPA / 2) * TPA + tt % TPA;
    mbar_expect_tx(full + sl, STAGE);
    bulk_load(stg + sl * STAGE, tiles + ti * (STAGE / 4), STAGE, full + sl);
  };
  if (tid == 0) {
    for (int i = 0; i < NR; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int tt = 0; tt < min(NR, total); ++tt) load(tt);
  load_tile(xs[0], f0 + base, C, ROWS, C / 32, vrows, C, tid, THREADS);
  load_tile(xs[1], f1 + base, C, ROWS, C / 32, vrows, C, tid, THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  int t = 0;
  // The next tile's stage, its big and small parts ready for wgmma. The
  // previous tile's stage, whose products are done (release's barrier),
  // takes the tile NR on. No block barrier here: the stage landed (the
  // mbarrier), and each warp's A fragments are the 16 rows its own lanes
  // wrote. Those rows cross lanes, so every epilogue store that a
  // projection reads with no block barrier between (LN2's, read by the next
  // application) ends in a __syncwarp; the window passes, which cross
  // warps, have block barriers of their own.
  auto acquire = [&]() -> const char* {
    const int sl = t % NR;
    mbar_wait(full + sl, (t / NR) & 1);
    if (tid == 0 && t >= 1 && t - 1 + NR < total) load(t - 1 + NR);
    return stg + sl * STAGE;
  };
  auto release = [&]() {
    __syncthreads();
    ++t;
  };
  auto store = [&](char* tile, int j, int h, float a0, float a1) {
    *(float2*)(tile + swz4(ROWS, r0 + 8 * h, 8 * j + c0)) = make_float2(a0, a1);
  };
  float accp[1][C / 2];
  float(&acc)[C / 2] = accp[0];
// acc = A W^T over the four 32-column slabs of W, A a 64-row float32 tile
// split into TF32 fragments as it is read; each k8 step's products are a
// commit group of their own, so the next step's fragments are read and
// split while the tensor cores run
#define FAR_K3_TF32_PROJECT(A)                                                   \
  _Pragma("unroll") for (int e_ = 0; e_ < C / 2; ++e_) acc[e_] = 0.f;            \
  for (int k_ = 0; k_ < C / 32; ++k_) {                                          \
    const char* st_ = acquire();                                                 \
    uint32_t fb_[4][4], fs_[4][4];                                               \
    _Pragma("unroll") for (int kk = 0; kk < 4; ++kk) {                           \
      a_frag((A), r0, 32 * k_ + 8 * kk + k0, fb_[kk], fs_[kk]);                  \
      wg_fence();                                                                \
      mma3(acc, fb_[kk], fs_[kk], st_ + kk * 32, st_ + TILE + kk * 32);          \
      wg_commit();                                                               \
    }                                                                            \
    wg_wait<0>();                                                                \
    keep(acc);                                                                   \
    keep(fb_);                                                                   \
    keep(fs_);                                                                   \
    release();                                                                   \
  }

  for (int app = 0; app < 2 * n_layers; ++app) {
    const int li = app >> 1, img = app & 1;
    char* xt = xs[img];
    const char* yt = (cross_mask >> li) & 1 ? xs[img ^ 1] : xt;
    const float* lnl = ln + (size_t)li * 4 * C;

    // k = elu(src Wk^T) + 1, v = src Wv^T (1 / s)
    FAR_K3_TF32_PROJECT(yt)
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(ab, j, h, elu1(acc[4 * j + 2 * h]), elu1(acc[4 * j + 2 * h + 1]));
    FAR_K3_TF32_PROJECT(yt)
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(vb, j, h, acc[4 * j + 2 * h] * inv_s, acc[4 * j + 2 * h + 1] * inv_s);
    __syncthreads();

    // per window and head, on the CUDA cores: KV = k^T v and sum(k); a
    // thread owns row i of one (window, head)
    for (int e = tid; e < wpb * H * DH; e += THREADS) {
      const int i = e % DH, hd = (e / DH) % H, w = e / (DH * H);
      float a[DH];
#pragma unroll
      for (int j = 0; j < DH; ++j) a[j] = 0.f;
      float ks = 0.f;
      for (int r = w * s; r < (w + 1) * s; ++r) {
        const float kr = ld4(ab, r, hd * DH + i);
        ks += kr;
#pragma unroll
        for (int j = 0; j < DH; j += 4) {
          const float4 v4 = *(const float4*)(vb + swz4(ROWS, r, hd * DH + j));
          a[j] = fmaf(kr, v4.x, a[j]);
          a[j + 1] = fmaf(kr, v4.y, a[j + 1]);
          a[j + 2] = fmaf(kr, v4.z, a[j + 2]);
          a[j + 3] = fmaf(kr, v4.w, a[j + 3]);
        }
      }
      float* o = kv + w * KVW<DH> + hd * NEL;
#pragma unroll
      for (int j = 0; j < DH; j += 4)
        *(float4*)(o + i * DH + j) = make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
      o[DH * DH + i] = ks;
    }

    // q = elu(x Wq^T) + 1 over k (every thread is past the KV loop once the
    // projection's first barrier has passed)
    FAR_K3_TF32_PROJECT(xt)
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(ab, j, h, elu1(acc[4 * j + 2 * h]), elu1(acc[4 * j + 2 * h + 1]));
    __syncthreads();

    // msg = q_h KV_h * s / (q_h . sum(k_h) + 1e-6) over v; a thread owns one
    // (row, head); zero rows past the block's windows get msg = 0
    for (int e = tid; e < ROWS * H; e += THREADS) {
      const int r = e % ROWS, hd = e / ROWS, w = r / s;
      float q[DH], m[DH];
#pragma unroll
      for (int j = 0; j < DH; j += 4) {
        const float4 q4 = *(const float4*)(ab + swz4(ROWS, r, hd * DH + j));
        q[j] = q4.x, q[j + 1] = q4.y, q[j + 2] = q4.z, q[j + 3] = q4.w;
      }
#pragma unroll
      for (int j = 0; j < DH; ++j) m[j] = 0.f;
      if (w < wpb) {
        const float* o = kv + w * KVW<DH> + hd * NEL;
        float den = 0.f;
#pragma unroll
        for (int i = 0; i < DH; ++i) den = fmaf(q[i], o[DH * DH + i], den);
#pragma unroll
        for (int i = 0; i < DH; ++i)
#pragma unroll
          for (int j = 0; j < DH; j += 4) {
            const float4 k4 = *(const float4*)(o + i * DH + j);
            m[j] = fmaf(q[i], k4.x, m[j]);
            m[j + 1] = fmaf(q[i], k4.y, m[j + 1]);
            m[j + 2] = fmaf(q[i], k4.z, m[j + 2]);
            m[j + 3] = fmaf(q[i], k4.w, m[j + 3]);
          }
        const float z = 1.f / (den + 1e-6f);
#pragma unroll
        for (int j = 0; j < DH; ++j) m[j] = m[j] * z * (float)s;
      }
#pragma unroll
      for (int j = 0; j < DH; j += 4)
        *(float4*)(vb + swz4(ROWS, r, hd * DH + j)) = make_float4(m[j], m[j + 1], m[j + 2], m[j + 3]);
    }
    __syncthreads();

    // m = LN1(msg Wm^T) over q, the LayerNorm in the accumulators
    FAR_K3_TF32_PROJECT(vb)
    {
      float mu[2], rstd[2];
      acc_row_stats(accp, mu, rstd, C);
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * j + c0;
          store(ab, j, h,
                (acc[4 * j + 2 * h] - mu[h]) * rstd[h] * __ldg(lnl + col) + __ldg(lnl + C + col),
                (acc[4 * j + 2 * h + 1] - mu[h]) * rstd[h] * __ldg(lnl + col + 1) +
                    __ldg(lnl + C + col + 1));
        }
    }

    // out_pre = relu(x W0x^T + m W0m^T) W1^T, 64 columns of y at a time, each
    // chunk split into A fragments in registers and fed straight into the
    // W1^T accumulator (mlp.2's K order permuted to match, prep_weights_kernel)
#pragma unroll
    for (int e = 0; e < C / 2; ++e) acc[e] = 0.f;
    for (int c = 0; c < 2 * C / 64; ++c) {
      float ya[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) ya[e] = 0.f;
      for (int part = 0; part < 4; ++part) {
        const char* st = acquire();
        const char* a = part < 2 ? xt : ab;
        uint32_t fb[8][4], fs[8][4];
        keep(acc);
#pragma unroll
        for (int kb = 0; kb < 8; ++kb) {
          const int bo = (kb >> 2) * 64 * 128 + (kb & 3) * 32;
          a_frag(a, r0, 64 * (part & 1) + 8 * kb + k0, fb[kb], fs[kb]);
          wg_fence();
          mma3(ya, fb[kb], fs[kb], st + bo, st + TILE + bo);
          wg_commit();
        }
        wg_wait<0>();
        keep(ya);
        keep(fb);
        keep(fs);
        release();
      }
      uint32_t yb[8][4], ys[8][4];
#pragma unroll
      for (int e = 0; e < 32; ++e) ya[e] = fmaxf(ya[e], 0.f);
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) frag_tf32(ya, kb, yb[kb], ys[kb]);
      for (int half = 0; half < 2; ++half) {
        const char* st = acquire();
        keep(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma3(acc, yb[4 * half + kk], ys[4 * half + kk], st + kk * 32, st + TILE + kk * 32);
        wg_commit();
        wg_wait<0>();
        keep(acc);
        keep(yb);
        keep(ys);
        release();
      }
    }

    // x = x + LN2(out_pre), in place (every read of x is past the last barrier)
    {
      float mu[2], rstd[2];
      acc_row_stats(accp, mu, rstd, C);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const int col = 8 * j + c0;
          float2* px = (float2*)(xt + swz4(ROWS, row, col));
          const float2 xv = *px;
          *px = make_float2(
              xv.x + ((acc[4 * j + 2 * h] - mu[h]) * rstd[h] * __ldg(lnl + 2 * C + col) +
                      __ldg(lnl + 3 * C + col)),
              xv.y + ((acc[4 * j + 2 * h + 1] - mu[h]) * rstd[h] * __ldg(lnl + 2 * C + col + 1) +
                      __ldg(lnl + 3 * C + col + 1)));
        }
      }
      // the next application's first projection reads these rows with no
      // block barrier between (acquire)
      __syncwarp();
    }
  }

#undef FAR_K3_TF32_PROJECT
  __syncthreads();
  for (int i = tid; i < vrows * (C / 4); i += THREADS) {
    const int r = i / (C / 4), col = (i % (C / 4)) * 4;
    *(float4*)(out0 + base + (size_t)r * C + col) = *(const float4*)(xs[0] + swz4(ROWS, r, col));
    *(float4*)(out1 + base + (size_t)r * C + col) = *(const float4*)(xs[1] + swz4(ROWS, r, col));
  }
}

// Bytes of the weight tiles prep_weights_kernel writes.
size_t scratch_bytes(int n_layers) { return (size_t)n_layers * TPA * STAGE; }

template <int DH>
int run(const float* f0, const float* f1, const float* w, const float* ln, float* out0,
        float* out1, float* scratch, int n, int s, int n_layers, int cross_mask,
        cudaStream_t st) {
  const int wpb = ROWS / s, total = n_layers * TPA * (TILE / 4);
  prep_weights_kernel<<<(total + 255) / 256, 256, 0, st>>>(w, n_layers, scratch);
  constexpr int smem = SMEM<DH>;
  cudaError_t err = cudaFuncSetAttribute(fine_tf32_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fine_tf32_kernel<DH><<<(n + wpb - 1) / wpb, THREADS, smem, st>>>(
      f0, f1, scratch, ln, out0, out1, n, s, n_layers, cross_mask);
  return (int)cudaGetLastError();
}

}  // namespace tf32

// 1 when far_fine_transformer_tf32 takes (C, H, s): C = 128, a head width
// of 16 or 32, and windows of 22 <= s <= 64 tokens (2 or 1 whole windows a
// 64-row block: more would not leave their KV room in shared memory), else
// 0; the wrapper asks first.
extern "C" size_t far_fine_transformer_tf32_supports(int C, int H, int s) {
  const int DH = H > 0 && C % H == 0 ? C / H : 0;
  return C == tf32::C && (DH == 16 || DH == 32) && s >= 1 && s <= tf32::ROWS &&
         tf32::ROWS / s <= tf32::WPB;
}
// Bytes of the float32 route's scratch: the weights' big and small parts.
extern "C" size_t far_fine_transformer_tf32_scratch(int n_layers) {
  return tf32::scratch_bytes(n_layers);
}

// float32 route, 3xTF32: the arguments of far_fine_transformer in float32,
// scratch of far_fine_transformer_tf32_scratch bytes (the weights split once
// a call). A shape far_fine_transformer_tf32_supports refuses returns
// cudaErrorInvalidValue.
extern "C" int far_fine_transformer_tf32(const void* f0, const void* f1, const void* w,
                                         const void* ln, void* out0, void* out1, void* scratch,
                                         int n, int s, int C, int H, int n_layers, int cross_mask,
                                         void* stream) {
  if (!far_fine_transformer_tf32_supports(C, H, s) || n < 1 || n_layers < 1 || n_layers > 30)
    return (int)cudaErrorInvalidValue;
  using Run = int (*)(const float*, const float*, const float*, const float*, float*, float*,
                      float*, int, int, int, int, cudaStream_t);
  const Run run = C / H == 16 ? tf32::run<16> : tf32::run<32>;
  return run((const float*)f0, (const float*)f1, (const float*)w, (const float*)ln,
             (float*)out0, (float*)out1, (float*)scratch, n, s, n_layers, cross_mask,
             (cudaStream_t)stream);
}
