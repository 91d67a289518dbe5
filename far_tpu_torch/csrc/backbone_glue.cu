// The backbone's glue between two cuDNN convolutions: one pass over device
// memory a convolution output.
//
// Replaces no Pallas kernel: the JAX package leaves this glue to XLA's
// fusions. In PyTorch each step is a pass of its own: eval BatchNorm (a copy
// of the running mean, a kernel for 1/sqrt(var + eps) and the transform),
// ReLU, the residual add, LeakyReLU and the FPN's x2 upsample, each reading
// and writing a whole feature map (models/backbone.py). Here
// - far_bn_glue, mode 0: act(bn(y)), ReLU for slope 0, else LeakyReLU;
//   mode 1: relu(r + bn(y)) with r = res; mode 2: the same with r = bn_res(res);
// - far_up2_add: a + up2(small), bilinear x2 with align_corners=True.
//
// The same arithmetic as PyTorch's CUDA kernels, rounded at the same points,
// so that bf16 results are bit-equal to the unfused sequence on the card:
// - eval BatchNorm: inv = rsqrtf(var + eps) (batch_norm_calc_invstd), then
//   fma(w * (x - mean), inv, b) in float32 (the channels-last transform's
//   `w * (x - m) * inv + b` as nvcc contracts it), rounded once to the storage
//   type;
// - the add: the two rounded operands summed in float32, rounded once;
// - ReLU: NaN kept, else fmaxf(v, 0) (clamp_min); LeakyReLU: v > 0 ? v :
//   v * slope in float32, rounded (leaky_relu's opmath);
// - up2: upsample_bilinear2d's float32 source index scale * dst, its lambdas
//   (h1r - h1, 1 - h1lambda) and h0 * fma(w0, a, w1 * b) + h1 * (...) as
//   fma(h0, top, h1 * bottom), rounded before the add.
// Every operation is written with an _rn intrinsic, so no compiler contracts
// them otherwise. Parameters are read by pointer at each launch: nothing is
// folded at capture, and an in-place load_state_dict takes effect in replays.
//
// Bound: bytes. A few operations an element against 2 bytes in and 2 out
// (bf16). Each thread moves 16-byte vectors over the flat NHWC (or NCHW)
// elements in a grid-stride loop of one wave of blocks on the card's SMs,
// two vectors in flight, its index arithmetic by multiplies (Div). The 17
// calls of a 16-pair 480x640 request run at 76-80 % of an H100's 3.35 TB/s.
// The per-channel parameters (mean, 1/sqrt(var + eps), weight, bias; twice
// for mode 2) sit in a shared-memory table indexed by the element's channel,
// one word of padding every 32 so that lanes 8 channels apart (NHWC, 8 bf16
// a vector) hit distinct banks; a vector's channels follow from its first
// element's by counting, so 196 channels vectorise as 128 and 256 do. up2_add:
// one thread a run of VEC channels of one output pixel (16-byte vectors where
// C allows, else 8, 4 or 2 bytes); the four source pixels, a quarter of the
// output's bytes, come through L1/L2.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using far::from_f;
using far::to_f;

constexpr int THREADS = 256;
constexpr int UNROLL = 2;
constexpr int MAX_CHANNELS = 1024;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct BnArgs {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

// n / d and n % d for n < 2^31 by a multiply (Granlund and Montgomery; as
// PyTorch's IntDivider), d fixed for a launch: an integer division is ~20
// instructions, as many as the rest of a vector's index work.
struct Div {
  unsigned d, m, s;

  explicit Div(unsigned d_) : d(d_), m(0), s(0) {
    while (s < 32 && (1u << s) < d) ++s;
    m = (unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (unsigned)(((unsigned long long)__umulhi(n, m) + n) >> s);
  }
  __device__ __forceinline__ unsigned mod(unsigned n) const { return n - div(n) * d; }
};

__device__ __forceinline__ int padded(int c) { return c + (c >> 5); }

__device__ __forceinline__ float bn_value(float x, const float* tab, int pc, int k) {
  // tab: mean, 1/sqrt(var + eps), weight, bias, each pc floats
  return __fmaf_rn(__fmul_rn(tab[2 * pc + k], __fsub_rn(x, tab[k])), tab[pc + k],
                   tab[3 * pc + k]);
}

__device__ __forceinline__ float act(float v, float slope) {
  if (slope == 0.f) return isnan(v) ? v : fmaxf(v, 0.f);
  return v > 0.f ? v : __fmul_rn(v, slope);
}

// One element: y's value and (modes 1, 2) res's; c its channel.
template <typename T, int MODE>
__device__ __forceinline__ T glue_one(T y, T r, const float* tab, int pc, int c, float slope) {
  const int k = padded(c);
  float v = to_f(from_f<T>(bn_value(to_f(y), tab, pc, k)));
  if (MODE != 0) {
    float rr = to_f(r);
    if (MODE == 2) rr = to_f(from_f<T>(bn_value(rr, tab + 4 * pc, pc, k)));
    v = to_f(from_f<T>(__fadd_rn(rr, v)));
  }
  return from_f<T>(act(v, slope));
}

// n elements; an element's channel is (i / inner) % C: inner 1 (NHWC) where
// !NCHW, H * W where NCHW. UNROLL vectors a thread in flight at once.
template <typename T, int VEC, int MODE, bool NCHW>
__global__ void __launch_bounds__(THREADS)
    bn_glue_kernel(const T* __restrict__ y, const T* __restrict__ res, T* __restrict__ out,
                   BnArgs p, BnArgs q, float slope, unsigned n, Div Cd, Div inner) {
  extern __shared__ float tab[];
  const int C = (int)Cd.d;
  const int pc = padded(C - 1) + 1;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int k = padded(c);
    tab[k] = p.mean[c];
    tab[pc + k] = rsqrtf(__fadd_rn(p.var[c], p.eps));
    tab[2 * pc + k] = p.weight[c];
    tab[3 * pc + k] = p.bias[c];
    if (MODE == 2) {
      tab[4 * pc + k] = q.mean[c];
      tab[5 * pc + k] = rsqrtf(__fadd_rn(q.var[c], q.eps));
      tab[6 * pc + k] = q.weight[c];
      tab[7 * pc + k] = q.bias[c];
    }
  }
  __syncthreads();

  using P = Pack<T, VEC>;
  const unsigned nvec = n / VEC;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned base = blockIdx.x * blockDim.x + threadIdx.x; base < nvec;
       base += UNROLL * stride) {
    P yv[UNROLL], rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned v = base + u * stride;
      if (v < nvec) {
        yv[u] = reinterpret_cast<const P*>(y)[v];
        if (MODE != 0) rv[u] = reinterpret_cast<const P*>(res)[v];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned v = base + u * stride;
      if (v >= nvec) break;
      const unsigned i = v * VEC;
      const unsigned qi = NCHW ? inner.div(i) : i;
      unsigned r = NCHW ? i - qi * inner.d : 0;
      int c = (int)Cd.mod(qi);
      P ov;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ov.v[j] = glue_one<T, MODE>(yv[u].v[j], MODE != 0 ? rv[u].v[j] : yv[u].v[j], tab, pc, c,
                                    slope);
        if (!NCHW || ++r == inner.d) {
          r = 0;
          if (++c == C) c = 0;
        }
      }
      reinterpret_cast<P*>(out)[v] = ov;
    }
  }
  // the ragged tail: fewer than VEC elements
  const unsigned t = nvec * VEC + blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    const int c = (int)Cd.mod(NCHW ? inner.div(t) : t);
    out[t] = glue_one<T, MODE>(y[t], MODE != 0 ? res[t] : y[t], tab, pc, c, slope);
  }
}

// upsample_bilinear2d's source coordinate of output index d (align_corners):
// the source index s, the step to its neighbour (0 at the last) and the lambdas.
__device__ __forceinline__ void source(float scale, int d, int in, int& s, int& step, float& l0,
                                       float& l1) {
  const float r = __fmul_rn(scale, (float)d);
  s = (int)r;
  step = s < in - 1 ? 1 : 0;
  l1 = __fsub_rn(r, (float)s);
  l0 = __fsub_rn(1.f, l1);
}

__device__ __forceinline__ float lerp2(float l0, float a, float l1, float b) {
  return __fmaf_rn(l0, a, __fmul_rn(l1, b));
}

// NHWC: out (N, 2 H, 2 W, C) = a + up2(small (N, H, W, C)); one thread VEC
// channels of one output pixel. cv: C / VEC; W2, H2: 2 W, 2 H.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    up2_add_nhwc_kernel(const T* __restrict__ a, const T* __restrict__ small,
                        T* __restrict__ out, int N, int C, int H, int W, float rh, float rw,
                        Div cv, Div W2, Div H2) {
  using P = Pack<T, VEC>;
  const unsigned total = (unsigned)N * H2.d * W2.d * cv.d;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < total; v += stride) {
    const unsigned pix = cv.div(v);
    const int c = (int)(v - pix * cv.d) * VEC;
    const unsigned nh = W2.div(pix);
    const int w2 = (int)(pix - nh * W2.d);
    const unsigned n = H2.div(nh);
    const int h2 = (int)(nh - n * H2.d);
    int h1, hp, w1, wp;
    float h0l, h1l, w0l, w1l;
    source(rh, h2, H, h1, hp, h0l, h1l);
    source(rw, w2, W, w1, wp, w0l, w1l);
    const T* s00 = small + ((size_t)(n * H + h1) * W + w1) * C + c;
    const T* s10 = s00 + (size_t)hp * W * C;
    const P p00 = *reinterpret_cast<const P*>(s00);
    const P p01 = *reinterpret_cast<const P*>(s00 + wp * C);
    const P p10 = *reinterpret_cast<const P*>(s10);
    const P p11 = *reinterpret_cast<const P*>(s10 + wp * C);
    const P av = reinterpret_cast<const P*>(a)[v];
    P ov;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float top = lerp2(w0l, to_f(p00.v[j]), w1l, to_f(p01.v[j]));
      const float bot = lerp2(w0l, to_f(p10.v[j]), w1l, to_f(p11.v[j]));
      const float u = to_f(from_f<T>(lerp2(h0l, top, h1l, bot)));
      ov.v[j] = from_f<T>(__fadd_rn(to_f(av.v[j]), u));
    }
    reinterpret_cast<P*>(out)[v] = ov;
  }
}

// NCHW: one thread an output element.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    up2_add_nchw_kernel(const T* __restrict__ a, const T* __restrict__ small,
                        T* __restrict__ out, int N, int C, int H, int W, float rh, float rw) {
  const int H2 = 2 * H, W2 = 2 * W;
  const unsigned total = (unsigned)N * C * H2 * W2;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int w2 = (int)(i % W2);
    const unsigned rest = i / W2;
    const int h2 = (int)(rest % H2);
    const unsigned plane = rest / H2;  // n * C + c
    int h1, hp, w1, wp;
    float h0l, h1l, w0l, w1l;
    source(rh, h2, H, h1, hp, h0l, h1l);
    source(rw, w2, W, w1, wp, w0l, w1l);
    const T* s00 = small + ((size_t)plane * H + h1) * W + w1;
    const T* s10 = s00 + hp * W;
    const float top = lerp2(w0l, to_f(s00[0]), w1l, to_f(s00[wp]));
    const float bot = lerp2(w0l, to_f(s10[0]), w1l, to_f(s10[wp]));
    const float u = to_f(from_f<T>(lerp2(h0l, top, h1l, bot)));
    out[i] = from_f<T>(__fadd_rn(to_f(a[i]), u));
  }
}

// One wave: as many blocks as the card's SMs hold at once, fewer for a small
// input.
template <typename K>
int wave_blocks(K kernel, size_t smem, unsigned work) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  const unsigned need = (work + THREADS - 1) / THREADS;
  const unsigned wave = (unsigned)(sms > 0 ? sms : 1) * (unsigned)(per_sm > 0 ? per_sm : 1);
  return (int)(need < wave ? (need > 0 ? need : 1) : wave);
}

template <typename T, int VEC, int MODE>
cudaError_t launch_bn(const void* y, const void* res, void* out, BnArgs p, BnArgs q, float slope,
                      unsigned n, int C, unsigned inner, cudaStream_t s) {
  auto kernel = inner > 1 ? bn_glue_kernel<T, VEC, MODE, true> : bn_glue_kernel<T, VEC, MODE, false>;
  const size_t smem = (size_t)(MODE == 2 ? 8 : 4) * (C + (C >> 5) + 1) * sizeof(float);
  const int blocks = wave_blocks(kernel, smem, n / VEC > 0 ? n / VEC : n);
  kernel<<<blocks, THREADS, smem, s>>>((const T*)y, (const T*)res, (T*)out, p, q, slope, n,
                                       Div((unsigned)C), Div(inner));
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bn_vec(int mode, const void* y, const void* res, void* out, BnArgs p, BnArgs q,
                          float slope, unsigned n, int C, unsigned inner, cudaStream_t s) {
  if (mode == 0) return launch_bn<T, VEC, 0>(y, res, out, p, q, slope, n, C, inner, s);
  if (mode == 1) return launch_bn<T, VEC, 1>(y, res, out, p, q, slope, n, C, inner, s);
  return launch_bn<T, VEC, 2>(y, res, out, p, q, slope, n, C, inner, s);
}

template <typename T, int VEC>
cudaError_t launch_up_nhwc(const void* a, const void* small, void* out, int N, int C, int H, int W,
                           float rh, float rw, cudaStream_t s) {
  auto kernel = up2_add_nhwc_kernel<T, VEC>;
  const int blocks = wave_blocks(kernel, 0, (unsigned)N * 4 * H * W * (C / VEC));
  kernel<<<blocks, THREADS, 0, s>>>((const T*)a, (const T*)small, (T*)out, N, C, H, W, rh, rw,
                                    Div((unsigned)(C / VEC)), Div(2u * W), Div(2u * H));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_up(const void* a, const void* small, void* out, int N, int C, int H, int W,
                      int nchw, int vec_bytes, cudaStream_t s) {
  // upsample_bilinear2d's scales with align_corners: (in - 1) / (out - 1) in float32
  const float rh = 2 * H > 1 ? (float)(H - 1) / (float)(2 * H - 1) : 0.f;
  const float rw = 2 * W > 1 ? (float)(W - 1) / (float)(2 * W - 1) : 0.f;
  if (nchw) {
    auto kernel = up2_add_nchw_kernel<T>;
    const int blocks = wave_blocks(kernel, 0, (unsigned)N * C * 4 * H * W);
    kernel<<<blocks, THREADS, 0, s>>>((const T*)a, (const T*)small, (T*)out, N, C, H, W, rh, rw);
    return cudaGetLastError();
  }
  const int vec = vec_bytes / (int)sizeof(T);
  if (vec >= 8) return launch_up_nhwc<T, 8>(a, small, out, N, C, H, W, rh, rw, s);
  if (vec >= 4) return launch_up_nhwc<T, 4>(a, small, out, N, C, H, W, rh, rw, s);
  if (vec >= 2) return launch_up_nhwc<T, 2>(a, small, out, N, C, H, W, rh, rw, s);
  return launch_up_nhwc<T, 1>(a, small, out, N, C, H, W, rh, rw, s);
}

}  // namespace

// y, res, out: n elements of one layout (inner 1: NHWC, H * W: NCHW), C
// channels; dtype 0 float32, 1 bfloat16; mode 0 act(bn(y)), 1 relu(res +
// bn(y)), 2 relu(bn_res(res) + bn(y)); the BatchNorms' mean, var, weight and
// bias float32 on the card (res and bn_res unused where the mode has none).
// vec: 1 for one element a load, else 16-byte vectors (every pointer aligned).
extern "C" int far_bn_glue(const void* y, const void* res, void* out, const float* mean,
                           const float* var, const float* weight, const float* bias,
                           const float* mean_r, const float* var_r, const float* weight_r,
                           const float* bias_r, int n, int C, int inner, int dtype, int mode,
                           int vec, float eps, float eps_r, float slope, void* stream) {
  if (n < 0 || C < 1 || C > MAX_CHANNELS || inner < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const BnArgs p{mean, var, weight, bias, eps};
  const BnArgs q{mean_r, var_r, weight_r, bias_r, eps_r};
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned un = (unsigned)n, ui = (unsigned)inner;
  cudaError_t err;
  if (dtype == 1)
    err = vec > 1 ? launch_bn_vec<__nv_bfloat16, 8>(mode, y, res, out, p, q, slope, un, C, ui, s)
                  : launch_bn_vec<__nv_bfloat16, 1>(mode, y, res, out, p, q, slope, un, C, ui, s);
  else
    err = vec > 1 ? launch_bn_vec<float, 4>(mode, y, res, out, p, q, slope, un, C, ui, s)
                  : launch_bn_vec<float, 1>(mode, y, res, out, p, q, slope, un, C, ui, s);
  return (int)err;
}

// a, out (N, C, 2 H, 2 W) and small (N, C, H, W), all NHWC (nchw 0) or all
// NCHW (nchw 1); dtype 0 float32, 1 bfloat16. vec_bytes: the widest vector
// (16, 8, 4 or 2 bytes) that C channels fill and every pointer's alignment
// allows, NHWC only.
extern "C" int far_up2_add(const void* a, const void* small, void* out, int N, int C, int H, int W,
                           int nchw, int dtype, int vec_bytes, void* stream) {
  if (N < 0 || C < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      dtype == 1 ? launch_up<__nv_bfloat16>(a, small, out, N, C, H, W, nchw, vec_bytes, s)
                 : launch_up<float>(a, small, out, N, C, H, W, nchw, vec_bytes, s);
  return (int)err;
}
