// Fused soft-to-hard quantizer forward (kernel 1 of the port).
//
// Replaces the TPU kernel imgcomp_cvpr_tpu/ops/pallas/quantize.py::_forward
// (pl.pallas_call at :147, body _fwd_kernel :45-69). Per element x of the
// flattened bottleneck: squared distances to the L centers, the nearest
// center (strict '<', first minimum wins) -> qhard and the int32 symbol, and
// the streaming softmax of -sigma*d -> qsoft = E[centers]. The order of
// operations is the Pallas kernel's: max_neg over -sigma*d first, then the
// exp(-sigma*d - max_neg) sums, then numer / denom.
//
// Bound on the H100: memory. 16 bytes move per element (read x, write
// qsoft, qhard, symbol) against ~9 L flops, far below the ridge point. So:
//   - L is a template parameter (an L = 6 instance, and LMAX = 32 with the
//     loops guarded by l < L for any other L): every loop unrolls, the
//     centers and the nearest one's value sit in registers, nothing is
//     indexed at run time (no local memory);
//   - each thread moves 16 bytes an access: float4 x, qsoft and qhard, int4
//     symbols. The vector body starts at the first 16-byte-aligned element
//     of x; the few elements before it (an unaligned view) and after the
//     last whole vector (n not a multiple of 4) run scalar in the same
//     launch. Where the outputs are not aligned like x, everything runs
//     scalar (the wrapper allocates them so that they are);
//   - the grid is what the occupancy query says the card holds at once
//     (blocks an SM x SMs, from the first call on a device), striding over
//     the vectors.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_CENTERS 32
#define THREADS 256
#define MAX_DEVICES 64

template <int LMAX>
struct Centers {
  float c[LMAX];
};

template <int LMAX>
__device__ __forceinline__ void quantize_one(float v, const Centers<LMAX>& cs, int L,
                                             float neg_sigma, float& qs, float& qh,
                                             int& sym) {
  float best_dist = INFINITY, best_c = 0.f, max_neg = -INFINITY;
  int best_idx = 0;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (LMAX == 6 || l < L) {
      const float diff = v - cs.c[l];
      const float d = diff * diff;
      if (d < best_dist) { best_dist = d; best_idx = l; best_c = cs.c[l]; }
      max_neg = fmaxf(max_neg, neg_sigma * d);
    }
  }
  float denom = 0.f, numer = 0.f;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (LMAX == 6 || l < L) {
      const float c = cs.c[l];
      const float diff = v - c;
      const float e = expf(neg_sigma * (diff * diff) - max_neg);
      denom += e;
      numer += e * c;
    }
  }
  qs = numer / denom;
  qh = best_c;
  sym = best_idx;
}

// Elements [head, head + 4 nvec) as float4 / int4 vectors, the `head`
// elements before them and the n - head - 4 nvec after them one at a time.
template <int LMAX>
__global__ void __launch_bounds__(THREADS) quantize_fwd_kernel(
    const float* __restrict__ x, long long n, long long head, long long nvec,
    const float* __restrict__ centers, int L, float sigma, float* __restrict__ qsoft,
    float* __restrict__ qhard, int* __restrict__ sym) {
  const float neg_sigma = -sigma;
  Centers<LMAX> cs;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) cs.c[l] = (LMAX == 6 || l < L) ? __ldg(centers + l) : 0.f;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  float4* qs4 = reinterpret_cast<float4*>(qsoft + head);
  float4* qh4 = reinterpret_cast<float4*>(qhard + head);
  int4* s4 = reinterpret_cast<int4*>(sym + head);
  for (long long i = tid; i < nvec; i += stride) {
    const float4 v = x4[i];
    float4 qs, qh;
    int4 s;
    quantize_one(v.x, cs, L, neg_sigma, qs.x, qh.x, s.x);
    quantize_one(v.y, cs, L, neg_sigma, qs.y, qh.y, s.y);
    quantize_one(v.z, cs, L, neg_sigma, qs.z, qh.z, s.z);
    quantize_one(v.w, cs, L, neg_sigma, qs.w, qh.w, s.w);
    qs4[i] = qs;
    qh4[i] = qh;
    s4[i] = s;
  }
  const long long tail0 = head + 4 * nvec;
  for (long long i = tid; i < head + (n - tail0); i += stride) {
    const long long e = i < head ? i : tail0 + (i - head);
    quantize_one(x[e], cs, L, neg_sigma, qsoft[e], qhard[e], sym[e]);
  }
}

typedef void (*FwdKernel)(const float*, long long, long long, long long, const float*, int,
                          float, float*, float*, int*);

// Blocks of `kernel` the current device holds at once (occupancy x SMs),
// asked once per device and instance.
static int resident_blocks(FwdKernel kernel, int slot) {
  static int cache[2][MAX_DEVICES];
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

extern "C" int quantize_fwd(const float* x, long long n, const float* centers, int L,
                            float sigma, float* qsoft, float* qhard, int* sym,
                            cudaStream_t stream) {
  if (L < 1 || L > MAX_CENTERS || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uintptr_t mis = (uintptr_t)x & 15u;
  const bool same = mis % 4 == 0 && ((uintptr_t)qsoft & 15u) == mis &&
                    ((uintptr_t)qhard & 15u) == mis && ((uintptr_t)sym & 15u) == mis;
  long long head = same ? (long long)((16u - mis) & 15u) / 4 : n;
  if (head > n) head = n;
  const long long nvec = (n - head) / 4;
  const FwdKernel kernel = L == 6 ? quantize_fwd_kernel<6> : quantize_fwd_kernel<MAX_CENTERS>;
  const int resident = resident_blocks(kernel, L == 6 ? 0 : 1);
  if (resident < 1) return (int)cudaErrorInvalidDevice;
  const long long work = nvec > n - 4 * nvec ? nvec : n - 4 * nvec;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  kernel<<<(int)blocks, THREADS, 0, stream>>>(x, n, head, nvec, centers, L, sigma, qsoft,
                                              qhard, sym);
  return (int)cudaGetLastError();
}
