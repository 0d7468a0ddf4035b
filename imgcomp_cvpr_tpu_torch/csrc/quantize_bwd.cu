// Fused soft-to-hard quantizer backward (kernel 7 of the port).
//
// Replaces the TPU kernel imgcomp_cvpr_tpu/ops/pallas/quantize.py::_vjp_bwd
// (pl.pallas_call at :193, body _bwd_kernel :72-119). Per element x with
// cotangents g (of qsoft; the straight-through qbar's arrives through it)
// and gh (of qhard), p = softmax_l(-sigma (x - c_l)^2), qsoft = sum_l p_l c_l:
//   dx           = g * sum_l p_l (-2 sigma (x - c_l)) (c_l - qsoft)
//   dcenters_l   = sum over elements of
//                  g * p_l (1 + 2 sigma (x - c_l)(c_l - qsoft)) + gh [argmin == l]
// The softmax is the forward kernel's (max_neg first, expf(-sigma d - max_neg),
// numer / denom; strict '<' argmin); each e_l is computed once and kept in
// registers. Either cotangent pointer may be null and then counts as 0.
//
// Bound on the H100: memory. 12 bytes move per element (read x, g; write
// dx), 16 with gh, against ~L expf and ~10 L flops, far below the ridge
// point, but each element costs ~L expf and L + 1 divisions' worth of
// instructions, so the work of the whole grid must be resident at once: an
// L = 6 instance (every shipped config) held to 3 blocks of 256 threads an
// SM (<= 85 registers; the grid of the training z, 375 blocks, then runs in
// one wave on 132 SMs, where 104 registers took two), and LMAX = 32 with
// l < L guards for any other L; every loop unrolls; p_l = e_l * (1 / denom)
// with one division. As in kernel 1: 16-byte accesses (float4 x, g, gh, dx)
// from the first 16-byte-aligned element with a scalar head and tail in the
// same launch (everything scalar where the four pointers are not aligned
// alike).
//
// The per-center sums are deterministic, in one launch. The TPU grid is
// sequential, so its accumulation has one order; blocks here run in any
// order, so no float atomics: each thread keeps L partial sums in registers,
// a fixed shuffle tree reduces them within the warp, thread l adds the
// warps' rows in order and writes row blockIdx.x of a (blocks, L) scratch
// buffer. Then each block takes a ticket (__threadfence + atomicAdd on a
// counter); the block that draws the last one adds the rows, warp w taking
// columns w, w + 8, ..., lane j the rows j, j + 32, ... in order, then the
// same shuffle tree, and resets the counter to 0 for the next launch. The
// caller fixes the grid from n alone and keeps one scratch buffer and
// counter per (device, stream), so two calls on the same inputs give the
// same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_CENTERS 32
#define THREADS 256
#define WARPS (THREADS / 32)

template <int LMAX>
__device__ __forceinline__ void bwd_one(float v, float gi, float ghi, const float (&c)[LMAX],
                                        int L, float neg_sigma, float two_sigma,
                                        float (&acc)[LMAX], float& dx) {
  float e[LMAX];
  float best_dist = INFINITY, max_neg = -INFINITY;
  int best_idx = 0;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (LMAX == 6 || l < L) {
      const float diff = v - c[l];
      const float d = diff * diff;
      if (d < best_dist) { best_dist = d; best_idx = l; }
      max_neg = fmaxf(max_neg, neg_sigma * d);
    }
  }
  float denom = 0.f, numer = 0.f;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (LMAX == 6 || l < L) {
      const float diff = v - c[l];
      e[l] = expf(neg_sigma * (diff * diff) - max_neg);
      denom += e[l];
      numer += e[l] * c[l];
    }
  }
  const float qsoft = numer / denom;
  const float inv = 1.0f / denom;
  float dxs = 0.f;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (LMAX == 6 || l < L) {
      const float p = e[l] * inv;
      const float diff = v - c[l];
      const float t = c[l] - qsoft;
      dxs += p * (-two_sigma * diff) * t;
      const float dc = p * (1.0f + two_sigma * diff * t);
      acc[l] += gi * dc + (best_idx == l ? ghi : 0.f);
    }
  }
  dx = gi * dxs;
}

__device__ __forceinline__ float4 load4(const float4* p, long long i) {
  return p ? p[i] : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Elements [head, head + 4 nvec) as float4 vectors, the `head` elements
// before them and the n - head - 4 nvec after them one at a time.
template <int LMAX>
__global__ void __launch_bounds__(THREADS, LMAX == 6 ? 3 : 1) quantize_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ gh,
    long long n, long long head, long long nvec, const float* __restrict__ centers, int L,
    float sigma, float* __restrict__ dx, float* __restrict__ partial,
    unsigned int* __restrict__ counter, float* __restrict__ dcenters) {
  __shared__ float warp_sums[WARPS][LMAX];
  __shared__ bool last;
  const float neg_sigma = -sigma;
  const float two_sigma = 2.0f * sigma;
  float c[LMAX], acc[LMAX];
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    c[l] = (LMAX == 6 || l < L) ? __ldg(centers + l) : 0.f;
    acc[l] = 0.f;
  }
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const float4* g4 = g ? reinterpret_cast<const float4*>(g + head) : nullptr;
  const float4* gh4 = gh ? reinterpret_cast<const float4*>(gh + head) : nullptr;
  float4* dx4 = reinterpret_cast<float4*>(dx + head);
  for (long long i = tid; i < nvec; i += stride) {
    const float4 v = x4[i], gv = load4(g4, i), hv = load4(gh4, i);
    float4 d;
    bwd_one(v.x, gv.x, hv.x, c, L, neg_sigma, two_sigma, acc, d.x);
    bwd_one(v.y, gv.y, hv.y, c, L, neg_sigma, two_sigma, acc, d.y);
    bwd_one(v.z, gv.z, hv.z, c, L, neg_sigma, two_sigma, acc, d.z);
    bwd_one(v.w, gv.w, hv.w, c, L, neg_sigma, two_sigma, acc, d.w);
    dx4[i] = d;
  }
  const long long tail0 = head + 4 * nvec;
  for (long long i = tid; i < head + (n - tail0); i += stride) {
    const long long j = i < head ? i : tail0 + (i - head);
    bwd_one(x[j], g ? g[j] : 0.f, gh ? gh[j] : 0.f, c, L, neg_sigma, two_sigma, acc, dx[j]);
  }

  // This block's row of partial sums.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    float s = acc[l];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[warp][l] = s;
  }
  __syncthreads();
  if (threadIdx.x < L) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += warp_sums[w][threadIdx.x];
    partial[(long long)blockIdx.x * L + threadIdx.x] = s;
  }

  // The ticket: the block that finishes last adds the rows.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int blocks = (int)gridDim.x;
  for (int l = warp; l < L; l += WARPS) {
    // Rows lane, lane + 32, ... added in that order; each lane's loads of
    // 8 rows are in flight together (a row is an L2 trip).
    float s = 0.f;
    for (int b0 = lane; b0 < blocks; b0 += 8 * 32) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[k] = b0 + 32 * k < blocks ? __ldcg(partial + (long long)(b0 + 32 * k) * L + l) : 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (b0 + 32 * k < blocks) s += v[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) dcenters[l] = s;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// x, dx: n floats; g, gh: n floats or null; centers, dcenters: L floats;
// partial: blocks * L floats of scratch; counter: one unsigned int that is 0
// before the launch (and is again after it). ``blocks`` is the caller's, a
// function of n alone.
extern "C" int quantize_bwd(const float* x, const float* g, const float* gh, long long n,
                            const float* centers, int L, float sigma, float* dx,
                            float* dcenters, float* partial, unsigned int* counter,
                            int blocks, cudaStream_t stream) {
  if (L < 1 || L > MAX_CENTERS || blocks < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const uintptr_t mis = (uintptr_t)x & 15u;
  const bool same = mis % 4 == 0 && ((uintptr_t)dx & 15u) == mis &&
                    (!g || ((uintptr_t)g & 15u) == mis) && (!gh || ((uintptr_t)gh & 15u) == mis);
  long long head = same ? (long long)((16u - mis) & 15u) / 4 : n;
  if (head > n) head = n;
  const long long nvec = (n - head) / 4;
  if (L == 6) {  // every shipped config
    quantize_bwd_kernel<6><<<blocks, THREADS, 0, stream>>>(
        x, g, gh, n, head, nvec, centers, L, sigma, dx, partial, counter, dcenters);
  } else {
    quantize_bwd_kernel<MAX_CENTERS><<<blocks, THREADS, 0, stream>>>(
        x, g, gh, n, head, nvec, centers, L, sigma, dx, partial, counter, dcenters);
  }
  return (int)cudaGetLastError();
}
