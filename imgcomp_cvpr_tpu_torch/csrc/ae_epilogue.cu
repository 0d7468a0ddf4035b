// Fused eval-mode epilogue of the autoencoder's convolutions.
//
// Replaces no Pallas kernel: on the TPU, XLA fused BatchNorm (running
// statistics), the cast to the towers' dtype, ReLU and the residual adds into
// the convolution's consumer. Eager PyTorch ran that chain
// (ops/kernels/ae_epilogue.py::epilogue_plain) as about a dozen kernels a
// convolution, each a full pass over the activation, several of them in
// float32 and with broadcast operands that PyTorch does not vectorise.
//
// Per element of the conv output y (N, C, H, W) of type T (bf16 or f32):
//   t = ((float(y) - mean[c]) * mul[c]) + bias[c]   f32, each op rounded alone
//   o = T(t); with act, o = isnan(o) ? o : fmaxf(o, 0) (torch.relu's clamp_min)
//   o = T(float(o) + float(r0)); o = T(float(o) + float(r1))   (0 to 2 residuals)
// and o is written to a channels-last (N, H, W, C) output; the residuals
// have that layout too. Each op is the one the plain chain's PyTorch kernel
// runs, with __fsub_rn / __fmul_rn / __fadd_rn so that no FMA contraction
// moves a rounding: the output is bit-equal to the plain chain's on the same y.
//
// Bound on the H100: bytes. 2 + 2 residual reads and one write of T an
// element against 3 flops. So every element is read once and written once,
// in one launch:
//   - vector path (channel stride 1, C a multiple of 16 / sizeof(T), every
//     pointer and the other strides 16-byte aligned): a thread moves 16 bytes
//     an access (8 bf16 or 4 f32 channels of one pixel) of y, each residual
//     and the output. y is read through its strides, so a transposed conv's
//     TF-SAME crop is a view, not a copy; a packed y skips the index
//     arithmetic. A thread keeps its channels' 3 x V parameters in registers
//     and reloads them only when its channel group changes (never, where the
//     grid's stride is a multiple of C's vectors, as it is for C <= 2048);
//   - scalar path (C = 3, C = 33, any other layout): one element a thread;
//     consecutive threads write consecutive elements;
//   - the grid is what the occupancy query says the card holds at once
//     (from the first call on a device), striding over the work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define MAX_DEVICES 64

struct Args {
  const void* y;
  unsigned c, h, w;              // logical (N, C, H, W) sizes but N
  long long sn, sc, sh, sw;      // y's strides, in elements
  const float* mean;
  const float* mul;
  const float* bias;
  const void* r0;                // packed channels-last, or null
  const void* r1;
  void* out;                     // packed channels-last
  int act, nres;
};

// Element bits (uint16_t for bf16, uint32_t for f32) <-> float.
template <typename R>
struct Elem;
template <>
struct Elem<uint16_t> {
  static __device__ __forceinline__ float f(uint16_t v) {
    return __uint_as_float((unsigned)v << 16);   // exact, as __bfloat162float
  }
  static __device__ __forceinline__ uint16_t r(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <>
struct Elem<uint32_t> {
  static __device__ __forceinline__ float f(uint32_t v) { return __uint_as_float(v); }
  static __device__ __forceinline__ uint32_t r(float v) { return __float_as_uint(v); }
};

template <typename R>
__device__ __forceinline__ R epi(R yv, float m, float k, float b, int act, int nres, R r0,
                                 R r1) {
  typedef Elem<R> E;
  R o = E::r(__fadd_rn(__fmul_rn(__fsub_rn(E::f(yv), m), k), b));
  if (act) {
    const float f = E::f(o);
    o = E::r(isnan(f) ? f : fmaxf(f, 0.f));
  }
  if (nres > 0) o = E::r(__fadd_rn(E::f(o), E::f(r0)));
  if (nres > 1) o = E::r(__fadd_rn(E::f(o), E::f(r1)));
  return o;
}

template <typename R>
union Vec {
  uint4 u;
  R e[16 / sizeof(R)];
};

// Vectors [0, nvec) of V = 16 / sizeof(R) channels; vector i holds pixel
// i / (C / V) and channels from (i % (C / V)) * V.
template <typename R>
__global__ void __launch_bounds__(THREADS) epilogue_vec(Args a, unsigned nvec, int packed) {
  constexpr int V = 16 / sizeof(R);
  const unsigned cv = a.c / V, hw = a.h * a.w;
  const R* y = static_cast<const R*>(a.y);
  const uint4* r0 = static_cast<const uint4*>(a.r0);
  const uint4* r1 = static_cast<const uint4*>(a.r1);
  uint4* out = static_cast<uint4*>(a.out);
  float m[V], k[V], b[V];
  unsigned cur = 0xffffffffu;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < nvec; i += gridDim.x * THREADS) {
    const unsigned p = i / cv;
    const unsigned c0 = (i - p * cv) * V;
    if (c0 != cur) {
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 mv = __ldg(reinterpret_cast<const float4*>(a.mean + c0 + j));
        const float4 kv = __ldg(reinterpret_cast<const float4*>(a.mul + c0 + j));
        const float4 bv = __ldg(reinterpret_cast<const float4*>(a.bias + c0 + j));
        m[j] = mv.x; m[j + 1] = mv.y; m[j + 2] = mv.z; m[j + 3] = mv.w;
        k[j] = kv.x; k[j + 1] = kv.y; k[j + 2] = kv.z; k[j + 3] = kv.w;
        b[j] = bv.x; b[j + 1] = bv.y; b[j + 2] = bv.z; b[j + 3] = bv.w;
      }
      cur = c0;
    }
    long long src;
    if (packed) {
      src = (long long)i * V;
    } else {
      const unsigned n = p / hw, rem = p - n * hw, hh = rem / a.w, ww = rem - hh * a.w;
      src = n * a.sn + hh * a.sh + ww * a.sw + c0;
    }
    Vec<R> yv, v0, v1, o;
    yv.u = *reinterpret_cast<const uint4*>(y + src);
    v0.u = a.nres > 0 ? r0[i] : make_uint4(0, 0, 0, 0);
    v1.u = a.nres > 1 ? r1[i] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < V; ++j)
      o.e[j] = epi<R>(yv.e[j], m[j], k[j], b[j], a.act, a.nres, v0.e[j], v1.e[j]);
    out[i] = o.u;
  }
}

// Elements [0, total) of the packed output, one at a time; y through any
// strides.
template <typename R>
__global__ void __launch_bounds__(THREADS) epilogue_scalar(Args a, unsigned total) {
  const unsigned hw = a.h * a.w;
  const R* y = static_cast<const R*>(a.y);
  const R* r0 = static_cast<const R*>(a.r0);
  const R* r1 = static_cast<const R*>(a.r1);
  R* out = static_cast<R*>(a.out);
  for (unsigned e = blockIdx.x * THREADS + threadIdx.x; e < total; e += gridDim.x * THREADS) {
    const unsigned p = e / a.c, c = e - p * a.c;
    const unsigned n = p / hw, rem = p - n * hw, hh = rem / a.w, ww = rem - hh * a.w;
    const R yv = y[n * a.sn + c * a.sc + hh * a.sh + ww * a.sw];
    out[e] = epi<R>(yv, __ldg(a.mean + c), __ldg(a.mul + c), __ldg(a.bias + c), a.act, a.nres,
                    a.nres > 0 ? r0[e] : R(0), a.nres > 1 ? r1[e] : R(0));
  }
}

typedef void (*VecKernel)(Args, unsigned, int);
typedef void (*ScalarKernel)(Args, unsigned);

// Blocks of `kernel` the current device holds at once (occupancy x SMs),
// asked once per device and instance (slot).
template <typename K>
static int resident_blocks(K kernel, int slot) {
  static int cache[4][MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 0;
  if (cache[slot][dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cache[slot][dev] = per_sm * sms;
  }
  return cache[slot][dev];
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename R>
static int launch(Args a, long long total, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(R);
  const bool vec = a.sc == 1 && a.c % V == 0 && a.sn % V == 0 && a.sh % V == 0 &&
                   a.sw % V == 0 && aligned16(a.y) && aligned16(a.out) &&
                   (a.nres < 1 || aligned16(a.r0)) && (a.nres < 2 || aligned16(a.r1)) &&
                   aligned16(a.mean) && aligned16(a.mul) && aligned16(a.bias);
  const int slot = (sizeof(R) == 2 ? 0 : 2) + (vec ? 0 : 1);
  const long long work = vec ? total / V : total;
  const int resident = vec ? resident_blocks<VecKernel>(epilogue_vec<R>, slot)
                           : resident_blocks<ScalarKernel>(epilogue_scalar<R>, slot);
  if (resident < 1) return (int)cudaErrorInvalidDevice;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > resident) blocks = resident;
  if (vec) {
    const int packed = a.sw == (long long)a.c && a.sh == (long long)a.w * a.c &&
                       a.sn == (long long)a.h * a.w * a.c;
    epilogue_vec<R><<<(int)blocks, THREADS, 0, stream>>>(a, (unsigned)work, packed);
  } else {
    epilogue_scalar<R><<<(int)blocks, THREADS, 0, stream>>>(a, (unsigned)work);
  }
  return (int)cudaGetLastError();
}

// y: the conv output (n, c, h, w) through strides (sn, sc, sh, sw), in
// elements; dtype 0 = float32, 1 = bfloat16. mean, mul, bias: (c,) float32.
// r0, r1: null or packed channels-last residuals of y's type (r1 only with
// r0); out: packed channels-last, y's type. Returns cudaGetLastError().
extern "C" int ae_epilogue(const void* y, int dtype, long long n, long long c, long long h,
                           long long w, long long sn, long long sc, long long sh,
                           long long sw, const float* mean, const float* mul,
                           const float* bias, int act, const void* r0, const void* r1,
                           void* out, cudaStream_t stream) {
  if ((dtype != 0 && dtype != 1) || n < 0 || c < 0 || h < 0 || w < 0 || (r1 && !r0))
    return (int)cudaErrorInvalidValue;
  const long long total = n * c * h * w;
  if (total == 0) return (int)cudaSuccess;
  if (total >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  Args a{y, (unsigned)c, (unsigned)h, (unsigned)w, sn, sc, sh, sw, mean, mul, bias,
         r0, r1, out, act ? 1 : 0, r1 ? 2 : (r0 ? 1 : 0)};
  return dtype == 1 ? launch<uint16_t>(a, total, stream) : launch<uint32_t>(a, total, stream);
}
