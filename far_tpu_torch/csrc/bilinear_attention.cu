// K4: dual-softmax bilinear attention of the EMM regressor.
//
// Replaces far_tpu/ops/bilinear_attention.py:bilinear_dual_softmax (the
// pl.pallas_call at :171 in _dispatch, body _kernel at :36). Per (batch,
// head): S = scale q k^T (N x N), A = softmax_rows(S) * softmax_cols(S),
// F = v^T A v (Dv x Dv, f32). A is never stored: at N=4800 one head's A
// is 92 MB of f32.
//
// float32 route (far_bilinear_dual_softmax), on the CUDA cores: a
// statistics pass over 64x64 tiles of S (shared with K2, common.cuh)
// gives the row and column (max, sum of exp); then one block per (head,
// 64-column tile) walks every row tile, rebuilds its tile of A and
// accumulates G[:, tile] = v^T A in f32 in shared memory, and ends with
// its partial F = G v[tile]. A small kernel sums the partials in order.
//
// bfloat16 route (far_bilinear_dual_softmax_tc), three launches, the
// products on the tensor cores (wgmma, hopper.cuh), tiles staged by
// cp.async into two stages:
//  (a) row_stats: one block per 128 rows n (two warpgroups of 64) streams
//      k in 128-row tiles, S = q k^T by wgmma, and keeps an online
//      (max, sum of 2^x) per row: alpha[n] = log2 of the row's softmax
//      denominator, in the log2 domain (scale * log2 e folded in).
//  (b) main: one block per 128 key columns m (a warpgroup owns 64)
//      streams q and v^T in 128-row tiles of n. wgmma gives S^T =
//      k[m] q[n]^T; the running column max cmax[m] and sum csum[m] are
//      kept per accumulator row with the TPU kernel's `fix` rescale,
//      P^T = 2^(s - alpha[n]) * 2^(s - cmax[m]) is rounded to bf16 and
//      fed from registers as the A operand of G^T[m, u] += P^T v[n]
//      (v^T K-major). At the end H = G / csum is rounded to bf16, stored
//      transposed, and F_part = H v[m] is one more wgmma; partials per
//      warpgroup go to device memory.
//  (c) sum_partials: adds them in order (the same result on every run).
// Bound on this card: the exponential unit (16 a clock per SM) before the
// tensor cores. The function needs 2 exponentials per element of S (one
// for the row sums; E = 2^(s - cmax) serves the column sums, and P =
// E^2 2^cmax[m] 2^-alpha[n] needs only per-row and per-column factors
// beside it); this route computes 3 (1 in row_stats, 2 in main). At
// N=4800 and 16 heads a launch then needs 1.1e9 ex2 (~0.28 ms at
// 1.83 GHz) against ~0.1 ms of tensor-core time. The design folds log2 e
// into the scale so each exponential is one ex2.approx, and keeps S, P
// and G on chip; the exponentials of one tile do not yet overlap the
// next tile's wgmma.
// Rounding to bf16 where the TPU kernel casts: P (:77) and H (:91); S, G,
// the statistics and F stay f32 as there. v is padded to 72 columns and
// transposed by the wrapper (wgmma N must be a multiple of 8); narrower
// q and k (D < 64) are padded to 64 with zero columns, which change no
// element of S.
#include "common.cuh"
#include "hopper.cuh"

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

// float32 route. q, k (BH, N, D), v (BH, N, Dv) contiguous; out (BH, Dv,
// Dv) float32.
extern "C" int far_bilinear_dual_softmax(const void* q, const void* k, const void* v, void* out,
                                         void* scratch, int BH, int N, int D, int Dv, float scale,
                                         void* stream) {
  return run<float>((const float*)q, (const float*)k, (const float*)v, (float*)out,
                    (char*)scratch, BH, N, D, Dv, scale, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// bfloat16 route on the tensor cores (see the note at the top).
// ---------------------------------------------------------------------------
namespace tc {

using bf = __nv_bfloat16;
using namespace far::hopper;

constexpr int THREADS = 256;  // two warpgroups
constexpr int MT = 128;       // rows (stats) or columns (main) a block owns
constexpr int NT = 128;       // rows of a streamed tile
constexpr int D = 64;         // head dimension of q and k
constexpr int DVP = 72;       // padded width of v
constexpr int QT = NT * D * 2;         // q or k tile: one atom of 128 rows
constexpr int VT = DVP * 128;          // one atom of v^T: 72 rows x 64 columns
constexpr int STAGE = 36864;           // q tile, v^T tile (2 atoms), alpha
constexpr int ST_V = QT, ST_ALPHA = QT + 2 * VT;
constexpr int SMEM_STATS = 3 * QT + 1024;
constexpr int SMEM_MAIN = QT + 2 * VT + 2 * STAGE + 1024;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(ST_ALPHA + NT * 4 <= STAGE, "stage layout");

// Accumulator columns at or past `valid` (of a tile's 128) become -inf:
// the ragged last tile.
__device__ __forceinline__ void mask_columns(float (&s)[64], int valid, int c0) {
#pragma unroll
  for (int e = 0; e < 64; ++e)
    if (8 * (e >> 2) + c0 + (e & 1) >= valid) s[e] = -INFINITY;
}

// (a) Grid (ceil(N / MT), BH). alpha (BH, ldn).
__global__ void __launch_bounds__(THREADS, 1)
row_stats_kernel(const bf* __restrict__ q, const bf* __restrict__ k, int N, int ldn, float sl2,
                 float* __restrict__ alpha) {
  extern __shared__ char smem_raw[];
  char* sm = align1024(smem_raw);
  char* qs = sm;
  char* kst = sm + QT;  // two stages of k tiles
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane & 3);
  const int bh = blockIdx.y, n0 = blockIdx.x * MT;
  const bf* qb = q + (size_t)bh * N * D;
  const bf* kb = k + (size_t)bh * N * D;
  const int nt = (N + NT - 1) / NT;
  load_tile(qs, qb + (size_t)n0 * D, D, MT, 1, N - n0, D, tid, THREADS);
  load_tile(kst, kb, D, NT, 1, N, D, tid, THREADS);
  cp_async_commit();
  float rmax[2] = {-INFINITY, -INFINITY}, rsum[2] = {0.f, 0.f};
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt)
      load_tile(kst + ((t + 1) & 1) * QT, kb + (size_t)(t + 1) * NT * D, D, NT, 1,
                N - (t + 1) * NT, D, tid, THREADS);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const char* kt = kst + (t & 1) * QT;
    float s[64];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, desc(qs + wg * 64 * 128 + kk * 32), desc(kt + kk * 32), kk != 0);
    wg_commit();
    wg_wait<0>();
    keep(s);
    __syncthreads();  // this stage is free for the load two tiles on
    if ((t + 1) * NT > N) mask_columns(s, N - t * NT, c0);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 64; ++e) tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], s[e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // sl2 > 0: the max commutes with the scale
      const float nm = fmaxf(rmax[h], quad_max(tmax[h]) * sl2);
      rsum[h] *= ex2(rmax[h] - nm);
      rmax[h] = nm;
    }
#pragma unroll
    for (int e = 0; e < 64; ++e)
      rsum[(e >> 1) & 1] += ex2(fmaf(s[e], sl2, -rmax[(e >> 1) & 1]));
  }
  // rows in [N, ldn) get 0, so that main never reads an unwritten value
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float tot = quad_sum(rsum[h]);
    const int n = n0 + 64 * wg + r0 + 8 * h;
    if (c0 == 0 && n < ldn) alpha[(size_t)bh * ldn + n] = n < N ? rmax[h] + __log2f(tot) : 0.f;
  }
}

// (b) Grid (ceil(N / MT), BH). vt (BH, DVP, ldn); fpart (BH, 2 * gridDim.x,
// DVP, DVP), one partial per warpgroup.
__global__ void __launch_bounds__(THREADS, 1)
main_kernel(const bf* __restrict__ q, const bf* __restrict__ k, const bf* __restrict__ vt,
            const float* __restrict__ alpha, int N, int ldn, float sl2,
            float* __restrict__ fpart) {
  extern __shared__ char smem_raw[];
  char* sm = align1024(smem_raw);
  char* kts = sm;                  // k rows m0.. : A of S^T
  char* vtm = sm + QT;             // v^T columns m0.. : B of the partial F
  char* stg = vtm + 2 * VT;        // two stages: q tile, v^T tile, alpha
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane & 3);
  const int bh = blockIdx.y, m0 = blockIdx.x * MT;
  const bf* qb = q + (size_t)bh * N * D;
  const bf* vtb = vt + (size_t)bh * DVP * ldn;
  const float* ab = alpha + (size_t)bh * ldn;
  const int nt = (N + NT - 1) / NT;
  load_tile(kts, k + ((size_t)bh * N + m0) * D, D, MT, 1, N - m0, D, tid, THREADS);
  load_tile(vtm, vtb + m0, ldn, DVP, 2, DVP, ldn - m0, tid, THREADS);
  auto issue = [&](int t) {
    char* st = stg + (t & 1) * STAGE;
    const int n0 = t * NT;
    load_tile(st, qb + (size_t)n0 * D, D, NT, 1, N - n0, D, tid, THREADS);
    load_tile(st + ST_V, vtb + n0, ldn, DVP, 2, DVP, ldn - n0, tid, THREADS);
    if (tid < NT / 4) {
      const int n = n0 + 4 * tid, left = 4 * (ldn - n);
      const int bytes = left < 0 ? 0 : (left > 16 ? 16 : left);
      cp_async16(st + ST_ALPHA + 16 * tid, bytes > 0 ? (const void*)(ab + n) : (const void*)ab,
                 bytes);
    }
  };
  issue(0);
  cp_async_commit();
  float cmax[2] = {-INFINITY, -INFINITY}, csum[2] = {0.f, 0.f}, g[36];
#pragma unroll
  for (int e = 0; e < 36; ++e) g[e] = 0.f;
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const char* st = stg + (t & 1) * STAGE;
    const float* al = (const float*)(st + ST_ALPHA);
    float s[64];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, desc(kts + wg * 64 * 128 + kk * 32), desc(st + kk * 32), kk != 0);
    wg_commit();
    wg_wait<0>();
    keep(s);
    if ((t + 1) * NT > N) mask_columns(s, N - t * NT, c0);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 64; ++e) tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], s[e]);
    float fix[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // sl2 > 0: the max commutes with the scale
      const float cn = fmaxf(cmax[h], quad_max(tmax[h]) * sl2);
      fix[h] = ex2(cmax[h] - cn);
      cmax[h] = cn;
      csum[h] *= fix[h];
    }
    // alpha is 0 past N, so masked columns give E = P = 0
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const float2 a = *(const float2*)(al + 8 * j + c0);
#pragma unroll
      for (int e = 4 * j; e < 4 * j + 4; ++e) {
        const int h = (e >> 1) & 1;
        const float E = ex2(fmaf(s[e], sl2, -cmax[h]));
        csum[h] += E;
        s[e] = E * ex2(fmaf(s[e], sl2, -((e & 1) ? a.y : a.x)));
      }
    }
    uint32_t pA[NT / 16][4];
#pragma unroll
    for (int kb = 0; kb < NT / 16; ++kb) frag(s, kb, pA[kb]);
#pragma unroll
    for (int e = 0; e < 36; ++e) g[e] *= fix[(e >> 1) & 1];
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < NT / 16; ++kb)
      wgmma_rs(g, pA[kb], desc(st + ST_V + (kb >> 2) * VT + (kb & 3) * 32), 1);
    wg_commit();
    wg_wait<0>();
    keep(g);
    keep(pA);
    __syncthreads();  // this stage is free for the load two tiles on
  }
  // H = G / csum in bf16, stored transposed (u rows, this warpgroup's 64 m
  // as K) over the first stage; rows u >= DVP are never read back.
  char* ht = stg + wg * QT;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / quad_sum(csum[h]);
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = 8 * j + c0 + e;
        *(bf*)(ht + swz(128, u, r0 + 8 * h)) = __float2bfloat16_rn(g[4 * j + 2 * h + e] * inv);
      }
  }
  fence_async_smem();
  wg_barrier(wg);
  float f0[36], f1[36];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc(vtm + wg * VT + kk * 32);
    wgmma_ss(f0, desc(ht + kk * 32), db, kk != 0);
    wgmma_ss(f1, desc(ht + 64 * 128 + kk * 32), db, kk != 0);
  }
  wg_commit();
  wg_wait<0>();
  keep(f0);
  keep(f1);
  float* fp = fpart + ((size_t)bh * 2 * gridDim.x + 2 * blockIdx.x + wg) * DVP * DVP;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = r0 + 8 * h;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int w = 8 * j + c0;
      *(float2*)(fp + u * DVP + w) = make_float2(f0[4 * j + 2 * h], f0[4 * j + 2 * h + 1]);
      if (u < DVP - 64)
        *(float2*)(fp + (64 + u) * DVP + w) = make_float2(f1[4 * j + 2 * h], f1[4 * j + 2 * h + 1]);
    }
  }
}

// (c) out (BH, Dv, Dv) = sum over the np partials (BH, np, DVP, DVP), in order.
__global__ void sum_partials_tc_kernel(const float* __restrict__ fpart, int BH, int np, int Dv,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BH * Dv * Dv) return;
  const int bh = i / (Dv * Dv), u = (i / Dv) % Dv, w = i % Dv;
  const float* p = fpart + (size_t)bh * np * DVP * DVP + u * DVP + w;
  float s = 0.f;
  for (int t = 0; t < np; ++t) s += p[(size_t)t * DVP * DVP];
  out[i] = s;
}

struct Scratch {
  float *alpha, *fpart;
  size_t bytes;
};

Scratch scratch_layout(char* base, int BH, int N) {
  const int ldn = (N + 7) / 8 * 8, nblk = (N + MT - 1) / MT;
  size_t off = 0;
  auto take = [&](size_t floats) {
    float* p = (float*)(base + off);
    off += (floats * sizeof(float) + 255) / 256 * 256;
    return p;
  };
  Scratch s;
  s.alpha = take((size_t)BH * ldn);
  s.fpart = take((size_t)BH * 2 * nblk * DVP * DVP);
  s.bytes = off;
  return s;
}

}  // namespace tc

extern "C" size_t far_bilinear_tc_scratch(int BH, int N) {
  return tc::scratch_layout(nullptr, BH, N).bytes;
}

// The widths the bfloat16 route takes: 0 -> D of q and k, 1 -> the padded
// width of v. The wrapper pads narrower inputs with zero columns.
extern "C" size_t far_bilinear_tc_width(int which) { return which == 0 ? tc::D : tc::DVP; }

// bfloat16 route. q, k (BH, N, 64) contiguous; vt (BH, 72, ldn) with
// ldn = N rounded up to a multiple of 8: v^T padded with zeros; out (BH,
// Dv, Dv) float32 with Dv <= 72; scale > 0.
extern "C" int far_bilinear_dual_softmax_tc(const void* q, const void* k, const void* vt,
                                            void* out, void* scratch, int BH, int N, int Dv,
                                            float scale, void* stream) {
  using namespace tc;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dv > DVP || N < 1 || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  Scratch s = scratch_layout((char*)scratch, BH, N);
  cudaError_t err = cudaFuncSetAttribute(row_stats_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_STATS);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAIN);
  if (err != cudaSuccess) return (int)err;
  const int ldn = (N + 7) / 8 * 8, nblk = (N + MT - 1) / MT;
  const float sl2 = scale * LOG2E;
  row_stats_kernel<<<dim3(nblk, BH), THREADS, SMEM_STATS, st>>>((const bf*)q, (const bf*)k, N,
                                                                ldn, sl2, s.alpha);
  main_kernel<<<dim3(nblk, BH), THREADS, SMEM_MAIN, st>>>((const bf*)q, (const bf*)k,
                                                          (const bf*)vt, s.alpha, N, ldn, sl2,
                                                          s.fpart);
  const int n = BH * Dv * Dv;
  sum_partials_tc_kernel<<<(n + 255) / 256, 256, 0, st>>>(s.fpart, BH, 2 * nblk, Dv,
                                                          (float*)out);
  return (int)cudaGetLastError();
}
