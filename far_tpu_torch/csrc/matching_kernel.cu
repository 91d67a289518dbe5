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
//
// CUDA-core route (far_dual_softmax_rowcol; float32, and bf16 with C >
// 256 or inv_temp <= 0): both passes walk 64x64 tiles of S, every tile an
// independent block (the TPU kernel's sequential grid loop becomes the
// tile grid), f32 FMAs (common.cuh), 6 launches. Cross-block reductions
// go through per-tile partials and a combine kernel, not atomics, so the
// result is the same on every run and the argmax keeps the first index on
// ties as jnp.argmax does.
//
// bfloat16 route (far_dual_softmax_rowcol_tc), the route of every
// far_forward request (models/matching.py casts f0, f1 to bf16 in f32
// models too), four launches, S on the tensor cores (wgmma m64n128k16,
// hopper.cuh), f1 streamed in 128-row tiles through two cp.async stages:
//  (a) stats: one block per (b, 128 rows of f0, a range of column tiles),
//      two warpgroups of 64 rows. S = f0 f1^T in f32 accumulators; x =
//      s * inv_temp * log2 e. Per row an online (max, sum of 2^(x - max))
//      over the block's columns; per column the (max, sum) over the
//      block's 128 rows (shuffles over the 8 rows of a warp, then the 8
//      warps through shared memory). Partials go to device memory.
//  (b) combine: merges them in order into alpha_i and beta_j, the log2 of
//      each row's and column's softmax denominator.
//  (c) conf: the same blocks recompute S; t = (2x - alpha_i) - beta_j is
//      computed once per element and both the row max (with its first
//      argmax: ascending columns, strict >, ties to the lower index across
//      lanes) and the column max are taken over that same float.
//  (d) combine: row_val = 2^(max t) over the column ranges in order,
//      col_max = 2^(max t) over the row tiles. conf = 2^t is monotone in
//      t, so the maxima and argmax are those of conf, and a mutual pair's
//      row_val and col_max are one float's 2^t: models/matching.py's test
//      row_val >= col_max[row_idx] keeps it.
// Exponentials: 2 per element of S in (a) (row sum, column sum), 0 in
// (c): only the B (L + S) results are exponentiated. S and conf never
// reach device memory. The column range per row tile is chosen on the
// host (pick_split) so that B * ceil(L / 128) * nsplit blocks fill the
// SMs in few waves. Shared memory at C=256: the f0 tile and two f1 stages
// of 64 KB, 4.5 KB for the column reductions, 198 KB in all (one block an
// SM); registers 222 (pass a) and 161 (pass c), no spills (-Xptxas -v).
// What holds it back: each tile's wgmma, wait and the column reductions'
// barriers run in series within a block. Nothing rounds to bf16 here: the
// inputs are bf16 and every statistic stays f32, as in the TPU kernel.
// C is padded with zero columns to a multiple of 64 by the wrapper; zero
// columns change no element of S.
#include "common.cuh"
#include "hopper.cuh"

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

// The CUDA-core route. dtype: 0 = float32, 1 = bfloat16. f0 (B, L, C), f1
// (B, S, C) contiguous.
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

// ---------------------------------------------------------------------------
// bfloat16 route on the tensor cores (see the note at the top).
// ---------------------------------------------------------------------------
namespace tc {

using bf = __nv_bfloat16;
using namespace far::hopper;

constexpr int THREADS = 256;  // two warpgroups of 64 f0 rows
constexpr int MT = 128;       // f0 rows a block owns (a row tile)
constexpr int NT = 128;       // f1 rows of a streamed tile (columns of S)
constexpr float LOG2E = 1.4426950408889634f;

template <int KA>  // 64-wide atoms of the (padded) channel width
struct Shape {
  static constexpr int CP = 64 * KA;
  static constexpr int TILE = 128 * KA * 128;  // one 128-row tile, KA atoms
  static constexpr int SMEM = 3 * TILE + 8 * NT * 4 + NT * 4 + 1024;
};

// Column reduction over the block's 128 rows. v holds, for this thread's
// 32 columns (slot 2j + e is column 8j + c0 + e), the merge of its two
// rows; returns to thread tid < 128 the result of column tid. Fixed order:
// the same result on every run. Ends with the block synchronised.
template <bool MAX>
__device__ __forceinline__ float block_col_reduce(float (&v)[32], float* red, int tid) {
  const int lane = tid & 31, w8 = tid / 32;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = MAX ? fmaxf(x, y) : x + y;
    }
    v[i] = x;
  }
  if (lane < 4)
#pragma unroll
    for (int i = 0; i < 32; ++i) red[w8 * NT + 8 * (i >> 1) + 2 * lane + (i & 1)] = v[i];
  __syncthreads();
  float r = MAX ? -INFINITY : 0.f;
  if (tid < NT)
#pragma unroll
    for (int w = 0; w < 8; ++w) r = MAX ? fmaxf(r, red[w * NT + tid]) : r + red[w * NT + tid];
  return r;
}

// Passes (a) (CONF = false) and (c) (CONF = true). Grid (nrt, nsplit, B):
// row tile, column range, batch element. ldl / lds: L and S rounded up to
// whole tiles.
//  (a) prow (B, nsplit, ldl) x 2: the row's (max, sum of 2^(x - max)) over
//      the block's columns, x = s * sl2 (log2 domain); pcol (B, nrt, lds)
//      x 2: the same per column over the block's rows.
//  (c) t = (2 x - alpha_i) - beta_j once per element; prow: the row's max t
//      and its first argmax (int) over the block's columns; pcol: the
//      column's max t over the block's rows.
template <int KA, bool CONF>
__global__ void __launch_bounds__(THREADS, 1)
pass_kernel(const bf* __restrict__ f0, const bf* __restrict__ f1, int L, int S, int ldl, int lds,
            float sl2, const float* __restrict__ alpha, const float* __restrict__ beta,
            float* __restrict__ prow_a, void* __restrict__ prow_b, float* __restrict__ pcol_a,
            float* __restrict__ pcol_b) {
  using Sh = Shape<KA>;
  constexpr int CP = Sh::CP;
  extern __shared__ char smem_raw[];
  char* sm = align1024(smem_raw);
  char* f0s = sm;                      // 128 f0 rows
  char* stg = sm + Sh::TILE;           // two stages of 128 f1 rows
  float* red = (float*)(stg + 2 * Sh::TILE);
  float* cmx = red + 8 * NT;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane & 3);
  const int rt = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y, b = blockIdx.z;
  const int nrt = gridDim.x, m0 = rt * MT, nct = (S + NT - 1) / NT;
  const int t0 = split * nct / nsplit, t1 = (split + 1) * nct / nsplit;
  const bf* fb = f1 + (size_t)b * S * CP;
  load_tile(f0s, f0 + ((size_t)b * L + m0) * CP, CP, MT, KA, L - m0, CP, tid, THREADS);
  load_tile(stg, fb + (size_t)t0 * NT * CP, CP, NT, KA, S - t0 * NT, CP, tid, THREADS);
  cp_async_commit();
  int row[2];
  bool rowok[2];
  float al[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = m0 + 64 * wg + r0 + 8 * h;
    rowok[h] = row[h] < L;
    if (CONF && rowok[h]) al[h] = alpha[(size_t)b * ldl + row[h]];
  }
  // (a): running (max, sum); (c): running (max t, first argmax)
  float ra[2] = {-INFINITY, -INFINITY}, rb[2] = {0.f, 0.f};
  int ri[2] = {0, 0};
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0;
    if (t + 1 < t1)
      load_tile(stg + ((i + 1) & 1) * Sh::TILE, fb + (size_t)(t + 1) * NT * CP, CP, NT, KA,
                S - (t + 1) * NT, CP, tid, THREADS);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const char* ft = stg + (i & 1) * Sh::TILE;
    float s[64];
    wg_fence();
#pragma unroll
    for (int a = 0; a < KA; ++a)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc(f0s + a * MT * 128 + wg * 64 * 128 + kk * 32),
                 desc(ft + a * NT * 128 + kk * 32), (a | kk) != 0);
    wg_commit();
    wg_wait<0>();
    keep(s);
    // (block_col_reduce's barrier frees this stage for the load two tiles on)
    const int col0 = t * NT;
    const bool ragged = col0 + NT > S;
    if (CONF) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const float2 be = *(const float2*)(beta + (size_t)b * lds + col0 + 8 * j + c0);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e) {
          const int h = (e >> 1) & 1;
          const float x = fmaf(s[e], 2.f * sl2, -al[h]) - ((e & 1) ? be.y : be.x);
          const bool ok = rowok[h] && !(ragged && col0 + 8 * j + c0 + (e & 1) >= S);
          s[e] = ok ? x : -INFINITY;
        }
      }
      float bv[2] = {-INFINITY, -INFINITY};
      int bi[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 64; ++e) {  // ascending columns: strict > keeps the first
        const int h = (e >> 1) & 1;
        if (s[e] > bv[h]) {
          bv[h] = s[e];
          bi[h] = col0 + 8 * (e >> 2) + c0 + (e & 1);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv[h], o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[h], o);
          if (ov > bv[h] || (ov == bv[h] && oi < bi[h])) {
            bv[h] = ov;
            bi[h] = oi;
          }
        }
        if (bv[h] > ra[h]) {  // ascending tiles
          ra[h] = bv[h];
          ri[h] = bi[h];
        }
      }
      float v[32];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) v[2 * j + e] = fmaxf(s[4 * j + e], s[4 * j + 2 + e]);
      const float cm = block_col_reduce<true>(v, red, tid);
      if (tid < NT && col0 + tid < S) pcol_a[((size_t)b * nrt + rt) * lds + col0 + tid] = cm;
    } else {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int h = (e >> 1) & 1;
        if (!rowok[h] || (ragged && col0 + 8 * (e >> 2) + c0 + (e & 1) >= S)) s[e] = -INFINITY;
      }
      // rows: online max and sum of 2^(x - max), x = s * sl2
      float tmax[2] = {-INFINITY, -INFINITY}, sub[2];
#pragma unroll
      for (int e = 0; e < 64; ++e) tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], s[e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // sl2 > 0: the max commutes with the scale
        const float nm = fmaxf(ra[h], quad_max(tmax[h]) * sl2);
        sub[h] = nm == -INFINITY ? 0.f : nm;
        rb[h] *= ex2(ra[h] - sub[h]);
        ra[h] = nm;
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) rb[(e >> 1) & 1] += ex2(fmaf(s[e], sl2, -sub[(e >> 1) & 1]));
      // columns: max over the block's rows, then the sum of 2^(x - max)
      float v[32];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) v[2 * j + e] = fmaxf(s[4 * j + e], s[4 * j + 2 + e]);
      const float cm = block_col_reduce<true>(v, red, tid);
      if (tid < NT) cmx[tid] = cm * sl2;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = cmx[8 * j + c0 + e];
          const float ms = m == -INFINITY ? 0.f : m;
          v[2 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -ms)) + ex2(fmaf(s[4 * j + 2 + e], sl2, -ms));
        }
      const float cs = block_col_reduce<false>(v, red, tid);
      if (tid < NT && col0 + tid < S) {
        const size_t o = ((size_t)b * nrt + rt) * lds + col0 + tid;
        pcol_a[o] = cmx[tid];
        pcol_b[o] = cs;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float tot = CONF ? 0.f : quad_sum(rb[h]);
    if (c0 == 0 && rowok[h]) {
      const size_t o = ((size_t)b * nsplit + split) * ldl + row[h];
      prow_a[o] = ra[h];
      if (CONF)
        ((int*)prow_b)[o] = ri[h];
      else
        ((float*)prow_b)[o] = tot;
    }
  }
}

// (b) alpha (B, ldl), beta (B, lds): log2 of each row's and column's
// softmax denominator (in units of x), partials merged in order; 0 past L
// and S.
__global__ void combine_stats_kernel(const float* __restrict__ pra, const float* __restrict__ prb,
                                     const float* __restrict__ pca, const float* __restrict__ pcb,
                                     int B, int L, int S, int ldl, int lds, int nsplit, int nrt,
                                     float* __restrict__ alpha, float* __restrict__ beta) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float *pa, *pb;
  float* out;
  int nt, valid, ld;
  if (i < B * ldl) {
    pa = pra, pb = prb, out = alpha, ld = ldl, nt = nsplit, valid = L;
  } else {
    i -= B * ldl;
    if (i >= B * lds) return;
    pa = pca, pb = pcb, out = beta, ld = lds, nt = nrt, valid = S;
  }
  const int b = i / ld, n = i % ld;
  if (n >= valid) {
    out[i] = 0.f;
    return;
  }
  const size_t base = (size_t)b * nt * ld + n;
  float m = -INFINITY;
  for (int t = 0; t < nt; ++t) m = fmaxf(m, pa[base + (size_t)t * ld]);
  float s = 0.f;
  for (int t = 0; t < nt; ++t) s += pb[base + (size_t)t * ld] * ex2(pa[base + (size_t)t * ld] - m);
  out[i] = m + log2f(s);
}

// (d) row_val = 2^(max t), row_idx its first argmax (splits in column
// order, strict >); col_max = 2^(max t) over the row tiles. Both maxima
// are of the same t values, so a mutual pair compares equal bit for bit.
__global__ void combine_conf_kernel(const float* __restrict__ prv, const int* __restrict__ pri,
                                    const float* __restrict__ pcm, int B, int L, int S, int ldl,
                                    int lds, int nsplit, int nrt, float* __restrict__ row_val,
                                    long long* __restrict__ row_idx, float* __restrict__ col_max) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * L) {
    const int b = i / L, r = i % L;
    float best = -INFINITY;
    int arg = 0;
    for (int k = 0; k < nsplit; ++k) {
      const size_t o = ((size_t)b * nsplit + k) * ldl + r;
      if (prv[o] > best) {
        best = prv[o];
        arg = pri[o];
      }
    }
    row_val[i] = ex2(best);
    row_idx[i] = arg;
    return;
  }
  i -= B * L;
  if (i >= B * S) return;
  const int b = i / S, c = i % S;
  float best = -INFINITY;
  for (int t = 0; t < nrt; ++t) best = fmaxf(best, pcm[((size_t)b * nrt + t) * lds + c]);
  col_max[i] = ex2(best);
}

// Column ranges per row tile: the count that finishes the grid in the
// fewest tile-times on this card (one block an SM; a block's own set-up
// counts as one more tile). The same shapes give the same split.
int pick_split(int B, int L, int S) {
  int dev = 0, nsm = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  const long nrt = (L + MT - 1) / MT, nct = (S + NT - 1) / NT;
  int best = 1;
  long best_cost = -1;
  for (int k = 1; k <= nct; ++k) {
    const long waves = (nrt * B * k + nsm - 1) / nsm;
    const long cost = waves * ((nct + k - 1) / k + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = k;
    }
  }
  return best;
}

struct Scratch {
  float *pra, *prb, *pca, *pcb, *alpha, *beta;
  size_t bytes;
};

Scratch scratch_layout(char* base, int B, int L, int S, int nsplit) {
  const size_t nrt = (L + MT - 1) / MT, nct = (S + NT - 1) / NT;
  const size_t ldl = nrt * MT, lds = nct * NT;
  size_t off = 0;
  auto take = [&](size_t floats) {
    float* p = (float*)(base + off);
    off += (floats * sizeof(float) + 255) / 256 * 256;
    return p;
  };
  Scratch s;
  s.pra = take(B * nsplit * ldl);
  s.prb = take(B * nsplit * ldl);  // float sums in (a), int argmaxes in (c)
  s.pca = take(B * nrt * lds);
  s.pcb = take(B * nrt * lds);
  s.alpha = take(B * ldl);
  s.beta = take(B * lds);
  s.bytes = off;
  return s;
}

template <int KA>
int run(const bf* f0, const bf* f1, float* row_val, long long* row_idx, float* col_max,
        char* scratch, int B, int L, int S, float inv_temp, cudaStream_t st) {
  using Sh = Shape<KA>;
  const int nsplit = pick_split(B, L, S);
  Scratch s = scratch_layout(scratch, B, L, S, nsplit);
  cudaError_t err = cudaFuncSetAttribute(pass_kernel<KA, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pass_kernel<KA, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nrt = (L + MT - 1) / MT, nct = (S + NT - 1) / NT;
  const int ldl = nrt * MT, lds = nct * NT;
  const float sl2 = inv_temp * LOG2E;
  const dim3 grid(nrt, nsplit, B);
  pass_kernel<KA, false><<<grid, THREADS, Sh::SMEM, st>>>(f0, f1, L, S, ldl, lds, sl2, nullptr,
                                                          nullptr, s.pra, s.prb, s.pca, s.pcb);
  const int nstat = B * (ldl + lds);
  combine_stats_kernel<<<(nstat + 255) / 256, 256, 0, st>>>(
      s.pra, s.prb, s.pca, s.pcb, B, L, S, ldl, lds, nsplit, nrt, s.alpha, s.beta);
  pass_kernel<KA, true><<<grid, THREADS, Sh::SMEM, st>>>(f0, f1, L, S, ldl, lds, sl2, s.alpha,
                                                         s.beta, s.pra, s.prb, s.pca, nullptr);
  const int nout = B * (L + S);
  combine_conf_kernel<<<(nout + 255) / 256, 256, 0, st>>>(s.pra, (const int*)s.prb, s.pca, B, L,
                                                          S, ldl, lds, nsplit, nrt, row_val,
                                                          row_idx, col_max);
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" size_t far_dual_softmax_tc_scratch(int B, int L, int S) {
  return tc::scratch_layout(nullptr, B, L, S, tc::pick_split(B, L, S)).bytes;
}

// The widest (padded) channel count the bfloat16 route takes; the wrapper
// pads C with zero columns to a multiple of 64 up to it.
extern "C" size_t far_dual_softmax_tc_width() { return 256; }

// bfloat16 route. f0 (B, L, C), f1 (B, S, C) bf16 contiguous with C in
// {64, 128, 192, 256}; inv_temp > 0.
extern "C" int far_dual_softmax_rowcol_tc(const void* f0, const void* f1, void* row_val,
                                          void* row_idx, void* col_max, void* scratch, int B,
                                          int L, int S, int C, float inv_temp, void* stream) {
  using bf = __nv_bfloat16;
  if (!(inv_temp > 0.f) || B < 1 || L < 1 || S < 1) return (int)cudaErrorInvalidValue;
#define FAR_K2_TC_RUN(KA)                                                                 \
  if (C == 64 * KA)                                                                       \
    return tc::run<KA>((const bf*)f0, (const bf*)f1, (float*)row_val, (long long*)row_idx, \
                       (float*)col_max, (char*)scratch, B, L, S, inv_temp,                 \
                       (cudaStream_t)stream);
  FAR_K2_TC_RUN(1) FAR_K2_TC_RUN(2) FAR_K2_TC_RUN(3) FAR_K2_TC_RUN(4)
#undef FAR_K2_TC_RUN
  return (int)cudaErrorInvalidValue;
}
