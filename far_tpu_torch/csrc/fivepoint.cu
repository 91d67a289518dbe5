// Nister's 5-point minimal solve: every candidate of a RANSAC round in one launch.
//
// Replaces no Pallas kernel: the JAX package's run_5point_essential
// (far_tpu/geometry/fivepoint.py) is plain jnp, which XLA fuses inside the
// jitted request. The port's plain version (far_tpu_torch/geometry/fivepoint.py,
// which the CPU runs) spends ~2,700 small tensor operations a call, each a
// node of the compiled request's CUDA graph: two calls were ~80 % of a B=1
// request's nodes. This kernel computes the same candidates in one launch.
//
// far_fivepoint: points1, points2 (n, 5, 2) float32, K-normalised, with
// p2^T E p1 = 0 -> E (n, R * 10, 3, 3) float32, Frobenius norm sqrt(2) where
// valid and the identity elsewhere, and valid (n, R * 10) bool; slot r * 10 + k
// holds root k of basis rotation r. The fixed tables come in one float32 array
// (ops/fivepoint.py: kernel_tables, the plain version's numpy arrays): the 10
// xy-nodes, V^-T, the 11 Chebyshev z-nodes, W^-1, the determinant's row mix Q,
// the Durand-Kerner start and the R basis rotations.
//
// The plain version's algorithm, constants and iteration counts, in float32
// (no fast-math; nvcc fuses a product into the next add, as everywhere in the
// port's kernels). One block a sample, one warp a basis rotation:
// 1. warp 0 builds the 5 x 9 epipolar system and its nullspace by five
//    Householder reflections of A^T (lanes over the 14 columns of [A^T | Q^T],
//    the sign, norm and beta as the plain version takes them); the block's
//    warps share it, and each mixes it by its rotation;
// 2. the 10 constraint values at the 11 x 10 (z, xy) nodes (lanes over the
//    110 points), C(z) = q^T V^-T, the mix Q C(z) summed over k in order, and
//    det C(z) by unpivoted elimination (lane z), scaled by max |det| + 1e-12
//    and interpolated through W^-1 to the degree-10 coefficients;
// 3. 64 Durand-Kerner steps (lane k follows root k; the product over the
//    other roots by shuffles), after the balancing z = s u with s clamped to
//    [1e-6, 1e6], |denominator| < 1e-20 replaced by 1e-20, each step clamped
//    to length 3, complex division as c10's (numpy's);
// 4. for each root C(z*) as in 2., C^T C with the ridge 1e-6 tr / 10 + 1e-30,
//    its Gauss-Jordan inverse (unpivoted, in place: the same operations as the
//    plain version's augmented form on every entry that is not a fixed 0 or 1),
//    4 steps of inverse iteration from 1 + 0.01 k; x, y from the nullvector,
//    E normalised to sqrt(2), and the plain version's tests (real_tol, 1e3
//    magnitudes, |v_9| > 1e-6, det_tol, finiteness).
// Divisions written as `c / x` in the plain version's tensors are reciprocals
// times c there (torch's __rtruediv__), and are so here.
//
// Bound: latency. Operations a sample with R = 2 rotations, from the schedule
// (a multiply-add 2 flops): the nullspace ~3.5e3; a rotation's C(z) 2.1e4
// (110 constraint evaluations of 187), q^T V^-T 2.2e4, the mix 2.1e4, the
// eliminations 7.0e3, Durand-Kerner 1.24e5 (64 steps x 10 roots x 194),
// C(z*) 3.9e4, C^T C 2.0e4, Gauss-Jordan 1.9e4, inverse iteration 9.8e3:
// ~2.84e5 a rotation, ~5.7e5 a sample (chip_smoke.py: fivepoint_flops). Bytes:
// 80 in and ~1.5 KB out a sample. A round of 102 samples at B=1 is ~0.06
// GFLOP, ~0.9 us on the CUDA cores; what bounds the kernel is the dependent
// chain of one problem (64 Durand-Kerner steps of a Horner pass, 10 shuffles
// and a complex division each), so its time is about one block's latency per
// wave: 0.093 ms at B=1, one wave of 102 blocks, on an H100. Shared
// memory: 9.1 KB a warp (two 11 x 10 x 10 buffers reused through the stages),
// ~20 KB a block at R = 2; nothing but E and valid is written to device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NR = 10;       // roots of det C(z): candidates a rotation
constexpr int NZ = 11;       // Chebyshev z-nodes
constexpr int NM = 10;       // constraints, xy-monomials, xy-nodes
constexpr int MAX_ROT = 4;   // basis rotations, one warp each
constexpr int DK_STEPS = 64;
constexpr int INV_STEPS = 4;
constexpr float EPS = 1e-12f;   // geometry/fivepoint.py: _EPS
constexpr float TINY = 1e-20f;  // Durand-Kerner's guards; the normalisation's
constexpr float RIDGE = 1e-6f;
constexpr unsigned FULL = 0xffffffffu;

// the fixed tables (ops/fivepoint.py: kernel_tables)
constexpr int T_XY = 0;                // (10, 2)
constexpr int T_VINV = T_XY + 2 * NM;  // (10, 10) V^-T
constexpr int T_Z = T_VINV + NM * NM;  // (11)
constexpr int T_WINV = T_Z + NZ;       // (11, 11)
constexpr int T_MIX = T_WINV + NZ * NZ;  // (10, 10) Q
constexpr int T_DK = T_MIX + NM * NM;  // (10) complex, (re, im)
constexpr int T_ROT = T_DK + 2 * NR;   // (R, 4, 4)

// a warp's shared memory, in floats
constexpr int W_EB = 0;              // (4, 9) the rotated basis
constexpr int W_DV = W_EB + 36;      // (11) det C at the z-nodes over max |det|
constexpr int W_CF = W_DV + 12;      // (11) det C's monomial coefficients
constexpr int W_RE = W_CF + 12;      // (10) the roots' real parts
constexpr int W_Q = W_RE + 12;       // (11, 10, 10) constraint values; Q C; C^T C, its inverse
constexpr int W_C = W_Q + NZ * 100;  // (11, 10, 10) C; the pivot columns, v, u
constexpr int W_SIZE = W_C + NZ * 100;
constexpr int MQ_SIZE = 128;         // [A^T | Q^T], 9 x 14 column-major

__device__ __forceinline__ float det3(const float* E) {
  return E[0] * (E[4] * E[8] - E[5] * E[7]) - E[1] * (E[3] * E[8] - E[5] * E[6]) +
         E[2] * (E[3] * E[7] - E[4] * E[6]);
}

// max that keeps a NaN, as torch's amax
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// (a + b i) / (c + d i) as c10::complex divides (numpy's way)
__device__ __forceinline__ void cdiv(float a, float b, float c, float d, float& re, float& im) {
  const float abs_c = fabsf(c), abs_d = fabsf(d);
  if (abs_c >= abs_d) {
    if (abs_c == 0.f && abs_d == 0.f) {
      re = a / abs_c;
      im = b / abs_d;
    } else {
      const float rat = d / c, scl = 1.f / (c + d * rat);
      re = (a + b * rat) * scl;
      im = (b - a * rat) * scl;
    }
  } else {
    const float rat = c / d, scl = 1.f / (d + c * rat);
    re = (a * rat + b) * scl;
    im = (b * rat - a) * scl;
  }
}

// The ten constraint values [det E, vec(2 E E^T E - tr(E E^T) E)] of
// E = x E0 + y E1 + z E2 + E3, eb the basis (4, 3, 3).
__device__ void constraints(const float* eb, float x, float y, float z, float* out) {
  float E[9], P[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) E[e] = x * eb[e] + y * eb[9 + e] + z * eb[18 + e] + eb[27 + e];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      P[i * 3 + j] =
          E[i * 3] * E[j * 3] + E[i * 3 + 1] * E[j * 3 + 1] + E[i * 3 + 2] * E[j * 3 + 2];
  const float tr = P[0] + P[4] + P[8];
  out[0] = det3(E);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float p = P[i * 3] * E[j] + P[i * 3 + 1] * E[3 + j] + P[i * 3 + 2] * E[6 + j];
      out[1 + i * 3 + j] = 2.f * p - tr * E[i * 3 + j];
    }
}

// C (n, 10, 10) from the constraint values q (n, 10 nodes, 10 constraints):
// C[i][m] = sum_j q[j][i] V^-T[j][m].
__device__ void c_from_q(const float* q, const float* vinv, float* C, int n, int lane) {
  for (int o = lane; o < n * 100; o += 32) {
    const float* qz = q + (o / 100) * 100;
    const int i = (o / 10) % 10, m = o % 10;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NM; ++j) s += qz[j * 10 + i] * vinv[j * 10 + m];
    C[o] = s;
  }
}

// det of the 10 x 10 A (changed in place) by unpivoted elimination.
__device__ float det_unpivoted(float* A) {
  float det = 1.f;
  for (int k = 0; k < NM; ++k) {
    const float piv = A[k * 10 + k];
    det *= piv;
    const float inv = fabsf(piv) < EPS ? 0.f : 1.f / piv;
    for (int i = k + 1; i < NM; ++i) {
      const float f = A[i * 10 + k] * inv;
      for (int j = k + 1; j < NM; ++j) A[i * 10 + j] -= f * A[k * 10 + j];
    }
  }
  return det;
}

// The sample's epipolar system and the Householder QR of M = A^T (9 x 5):
// mq holds [M | Qt] column-major, Qt from the identity; after the five
// reflections Qt's rows 5-8 span A's nullspace. Called by a whole warp.
__device__ void nullspace(const float* __restrict__ p1, const float* __restrict__ p2, float* mq,
                          int lane) {
  if (lane < 5) {
    const float x1 = p1[lane * 2], y1 = p1[lane * 2 + 1];
    const float x2 = p2[lane * 2], y2 = p2[lane * 2 + 1];
    float* a = mq + lane * 9;
    a[0] = x2 * x1;
    a[1] = x2 * y1;
    a[2] = x2;
    a[3] = y2 * x1;
    a[4] = y2 * y1;
    a[5] = y2;
    a[6] = x1;
    a[7] = y1;
    a[8] = 1.f;
  } else if (lane < 14) {
    for (int r = 0; r < 9; ++r) mq[lane * 9 + r] = r == lane - 5 ? 1.f : 0.f;
  }
  __syncwarp();
  for (int k = 0; k < 5; ++k) {
    float v[9];
    float nn = 0.f;
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      v[r] = mq[k * 9 + r] * (r >= k ? 1.f : 0.f);
      nn += v[r] * v[r];
    }
    const float snrm = (mq[k * 9 + k] >= 0.f ? 1.f : -1.f) * sqrtf(nn);
    float vtv = 0.f;
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      v[r] += snrm * (r == k ? 1.f : 0.f);
      vtv += v[r] * v[r];
    }
    const float beta = vtv > EPS ? (1.f / (vtv + EPS)) * 2.f : 0.f;
    __syncwarp();  // every lane has read column k before its lane rewrites it
    if (lane < 14) {
      float* col = mq + lane * 9;
      float w = 0.f;
#pragma unroll
      for (int r = 0; r < 9; ++r) w += v[r] * col[r];
#pragma unroll
      for (int r = 0; r < 9; ++r) col[r] -= beta * v[r] * w;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32 * MAX_ROT)
    fivepoint_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                     const float* __restrict__ tables, float* __restrict__ E_out,
                     uint8_t* __restrict__ valid_out, int n_rot, float real_tol, float det_tol) {
  extern __shared__ float smem[];
  const int n_tab = T_ROT + 16 * n_rot;
  float* tab = smem;
  float* mq = smem + ((n_tab + 3) & ~3);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* wb = mq + MQ_SIZE + warp * W_SIZE;
  float* eb = wb + W_EB;
  float* q = wb + W_Q;
  float* C = wb + W_C;
  const long long sample = blockIdx.x;

  for (int i = threadIdx.x; i < n_tab; i += blockDim.x) tab[i] = tables[i];
  if (warp == 0) nullspace(p1 + sample * 10, p2 + sample * 10, mq, lane);
  __syncthreads();

  // 1. this warp's rotation of the basis: Eb[k] = sum_m rot[k][m] E_m, with
  // E_m (3 x 3) = row 5 + m of Qt
  const float* rot = tab + T_ROT + warp * 16;
  for (int o = lane; o < 36; o += 32) {
    const int k = o / 9, e = o % 9;
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) s += rot[k * 4 + m] * mq[(5 + e) * 9 + 5 + m];
    eb[o] = s;
  }
  __syncwarp();

  // 2. det C(z) at the z-nodes and its coefficients
  for (int t = lane; t < NZ * NM; t += 32) {
    const int zi = t / NM, j = t % NM;
    constraints(eb, tab[T_XY + 2 * j], tab[T_XY + 2 * j + 1], tab[T_Z + zi],
                q + zi * 100 + j * 10);
  }
  __syncwarp();
  c_from_q(q, tab + T_VINV, C, NZ, lane);
  __syncwarp();
  const float* mix = tab + T_MIX;
  for (int o = lane; o < NZ * 100; o += 32) {  // Q C(z), summed over k in order
    const float* Cz = C + (o / 100) * 100;
    const int i = (o / 10) % 10, j = o % 10;
    float a = mix[i * 10] * Cz[j];
#pragma unroll
    for (int k = 1; k < NM; ++k) a = a + mix[i * 10 + k] * Cz[k * 10 + j];
    q[o] = a;
  }
  __syncwarp();
  const float det = lane < NZ ? det_unpivoted(q + lane * 100) : 0.f;
  float dmax = fabsf(det);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dmax = nan_max(dmax, __shfl_xor_sync(FULL, dmax, o));
  dmax += EPS;
  if (lane < NZ) wb[W_DV + lane] = det / dmax;
  __syncwarp();
  if (lane < NZ) {
    float c = 0.f;
#pragma unroll
    for (int zi = 0; zi < NZ; ++zi) c += wb[W_DV + zi] * tab[T_WINV + lane * NZ + zi];
    wb[W_CF + lane] = c;
  }
  __syncwarp();

  // 3. Durand-Kerner: lane k follows root k (lanes >= 10 a copy of root k % 10)
  const float* cf = wb + W_CF;
  float s = -INFINITY;
  {
    const float lead = cf[NR];
    const float safe = fabsf(lead) < TINY ? TINY : lead;
#pragma unroll
    for (int k = 0; k < NR; ++k)
      s = nan_max(s, powf(fabsf(cf[k] / safe), 1.f / (float)(NR - k)));
    s = isnan(s) ? s : fminf(fmaxf(s, 1e-6f), 1e6f);
  }
  float c[NR + 1];
#pragma unroll
  for (int d = 0; d <= NR; ++d) c[d] = cf[d] * powf(s, (float)d);
  const float top = c[NR];
#pragma unroll
  for (int d = 0; d <= NR; ++d) c[d] = c[d] / top;
  const int me = lane % NR;
  float wr = tab[T_DK + 2 * me], wi = tab[T_DK + 2 * me + 1];
  for (int it = 0; it < DK_STEPS; ++it) {
    float pr = c[NR], pi = 0.f;  // p(w) by Horner
#pragma unroll
    for (int k = NR - 1; k >= 0; --k) {
      const float tr = pr * wr - pi * wi, ti = pr * wi + pi * wr;
      pr = tr + c[k];
      pi = ti;
    }
    float dr = 1.f, di = 0.f;  // prod over j of (w - w_j + [j == k])
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const float xr = __shfl_sync(FULL, wr, j), xi = __shfl_sync(FULL, wi, j);
      const float ar = (wr - xr) + (j == me ? 1.f : 0.f), ai = (wi - xi) + 0.f;
      const float nr = dr * ar - di * ai, ni = dr * ai + di * ar;
      dr = nr;
      di = ni;
    }
    if (hypotf(dr, di) < TINY) {
      dr = TINY;
      di = 0.f;
    }
    float sr, si;
    cdiv(pr, pi, dr, di, sr, si);
    const float mag = hypotf(sr, si);
    if (mag > 3.f) {
      const float f = (1.f / mag) * 3.f;
      sr *= f;
      si *= f;
    }
    wr -= sr;
    wi -= si;
  }
  const float re = wr * s, im = wi * s;

  // 4. (x, y) of each root from the nullvector of C(z*)
  if (lane < NR) wb[W_RE + lane] = re;
  __syncwarp();
  for (int t = lane; t < NR * NM; t += 32) {
    const int k = t / NM, j = t % NM;
    constraints(eb, tab[T_XY + 2 * j], tab[T_XY + 2 * j + 1], wb[W_RE + k],
                q + k * 100 + j * 10);
  }
  __syncwarp();
  c_from_q(q, tab + T_VINV, C, NR, lane);
  __syncwarp();
  for (int o = lane; o < NR * 100; o += 32) {  // C^T C
    const float* Ck = C + (o / 100) * 100;
    const int a = (o / 10) % 10, b = o % 10;
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < NM; ++i) t += Ck[i * 10 + a] * Ck[i * 10 + b];
    q[o] = t;
  }
  __syncwarp();
  if (lane < NR) {  // + eps I, eps = 1e-6 tr / 10 + 1e-30
    float* M = q + lane * 100;
    float tr = 0.f;
    for (int a = 0; a < NM; ++a) tr += M[a * 11];
    const float eps = RIDGE * tr / (float)NM + 1e-30f;
    for (int a = 0; a < NM; ++a) M[a * 11] += eps;
  }
  __syncwarp();
  float* pivcol = C;  // C is done with
  for (int k = 0; k < NM; ++k) {  // Gauss-Jordan, in place, one (root, column) a task
    for (int o = lane; o < NR * NM; o += 32) pivcol[o] = q[(o / NM) * 100 + (o % NM) * 10 + k];
    __syncwarp();
    for (int o = lane; o < NR * NM; o += 32) {
      const int r = o / NM, j = o % NM;
      float* M = q + r * 100;
      const float* ck = pivcol + r * NM;
      // column j holds the inverse's column j once step j has run: before it,
      // the augmented form's identity column e_j
      const float pr = j == k ? 1.f / ck[k] : M[k * 10 + j] / ck[k];
#pragma unroll
      for (int i = 0; i < NM; ++i)
        M[i * 10 + j] = i == k ? pr : (j == k ? 0.f : M[i * 10 + j]) - ck[i] * pr;
    }
    __syncwarp();
  }
  float* v = C + 100;
  float* u = C + 200;
  if (lane < NR) {  // 1 + 0.01 k, normalised
    float* vk = v + lane * NM;
    float nn = 0.f;
    for (int a = 0; a < NM; ++a) {
      vk[a] = 1.f + 0.01f * (float)a;
      nn += vk[a] * vk[a];
    }
    const float d = sqrtf(nn) + TINY;
    for (int a = 0; a < NM; ++a) vk[a] = vk[a] / d;
  }
  __syncwarp();
  for (int it = 0; it < INV_STEPS; ++it) {
    for (int o = lane; o < NR * NM; o += 32) {
      const float* row = q + (o / NM) * 100 + (o % NM) * 10;
      const float* vr = v + (o / NM) * NM;
      float t = 0.f;
#pragma unroll
      for (int b = 0; b < NM; ++b) t += row[b] * vr[b];
      u[o] = t;
    }
    __syncwarp();
    if (lane < NR) {
      float nn = 0.f;
      for (int a = 0; a < NM; ++a) nn += u[lane * NM + a] * u[lane * NM + a];
      const float d = sqrtf(nn) + TINY;
      for (int a = 0; a < NM; ++a) v[lane * NM + a] = u[lane * NM + a] / d;
    }
    __syncwarp();
  }
  if (lane < NR) {
    const float* vk = v + lane * NM;
    const float wv = vk[9];
    const bool finite_xy = fabsf(wv) > 1e-6f;
    const float inv_w = finite_xy ? 1.f / wv : 0.f;
    const float x = vk[7] * inv_w, y = vk[8] * inv_w, z = re;
    float E[9];
    float nn = 0.f;
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      E[e] = x * eb[e] + y * eb[9 + e] + z * eb[18 + e] + eb[27 + e];
      nn += E[e] * E[e];
    }
    const float scale = (1.f / (sqrtf(nn) + EPS)) * 1.41421356f;
    bool finite = true;
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      E[e] *= scale;
      finite = finite && isfinite(E[e]);
    }
    const bool ok = fabsf(im) <= real_tol * (1.f + fabsf(re)) && finite_xy &&
                    fabsf(z) < 1e3f && fabsf(x) < 1e3f && fabsf(y) < 1e3f &&
                    fabsf(det3(E)) < det_tol && finite;
    const long long slot = (sample * n_rot + warp) * NR + lane;
    float* out = E_out + slot * 9;
#pragma unroll
    for (int e = 0; e < 9; ++e) out[e] = ok ? E[e] : (e % 4 == 0 ? 1.f : 0.f);
    valid_out[slot] = ok ? 1 : 0;
  }
}

// Dynamic shared memory of a block of n_rot warps, in bytes.
size_t smem_bytes(int n_rot) {
  return sizeof(float) * (((T_ROT + 16 * n_rot + 3) & ~3) + MQ_SIZE + n_rot * W_SIZE);
}

}  // namespace

extern "C" int far_fivepoint(const float* p1, const float* p2, const float* tables, float* E,
                             uint8_t* valid, int n, int n_rot, float real_tol, float det_tol,
                             void* stream) {
  if (n <= 0) return 0;
  if (n_rot < 1 || n_rot > MAX_ROT) return (int)cudaErrorInvalidValue;
  fivepoint_kernel<<<n, 32 * n_rot, smem_bytes(n_rot), (cudaStream_t)stream>>>(
      p1, p2, tables, E, valid, n_rot, real_tol, det_tol);
  return (int)cudaGetLastError();
}
