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
// Bound on the H100: memory. 16 bytes move per element (read x, g, gh; write
// dx) against ~L expf and ~10 L flops, far below the ridge point: one
// grid-stride pass with coalesced 4-byte accesses.
//
// The per-center sums are deterministic. The TPU grid is sequential, so its
// accumulation has one order; blocks here run in any order, so no atomics:
// each thread keeps L partial sums in registers, a fixed shuffle tree
// reduces them within the warp, thread l adds the warps' rows in order and
// writes row blockIdx.x of a (blocks, L) scratch buffer, and a second launch
// of one block adds the rows in a fixed order. The caller fixes the grid
// from n alone, so two calls on the same inputs give the same bits.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_CENTERS 32
#define THREADS 256

template <int LMAX>
__global__ void quantize_bwd_kernel(const float* __restrict__ x,
                                    const float* __restrict__ g,
                                    const float* __restrict__ gh, long long n,
                                    const float* __restrict__ centers_dev,
                                    int L, float sigma, float* __restrict__ dx,
                                    float* __restrict__ partial) {
  __shared__ float warp_sums[THREADS / 32][LMAX];
  const float neg_sigma = -sigma;
  const float two_sigma = 2.0f * sigma;
  float c_reg[LMAX], acc[LMAX], e[LMAX];
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    c_reg[l] = l < L ? centers_dev[l] : 0.f;
    acc[l] = 0.f;
  }
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float v = x[i];
    const float gi = g ? g[i] : 0.f;
    const float ghi = gh ? gh[i] : 0.f;
    float best_dist = INFINITY;
    int best_idx = 0;
    float max_neg = -INFINITY;
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      if (l < L) {
        const float diff = v - c_reg[l];
        const float d = diff * diff;
        if (d < best_dist) { best_dist = d; best_idx = l; }
        max_neg = fmaxf(max_neg, neg_sigma * d);
      }
    }
    float denom = 0.f, numer = 0.f;
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      if (l < L) {
        const float diff = v - c_reg[l];
        e[l] = expf(neg_sigma * (diff * diff) - max_neg);
        denom += e[l];
        numer += e[l] * c_reg[l];
      }
    }
    const float qsoft = numer / denom;
    float dxs = 0.f;
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      if (l < L) {
        const float c = c_reg[l];
        const float p = e[l] / denom;
        const float diff = v - c;
        const float t = c - qsoft;
        dxs += p * (-two_sigma * diff) * t;
        const float dc = p * (1.0f + two_sigma * diff * t);
        acc[l] += gi * dc + (best_idx == l ? ghi : 0.f);
      }
    }
    dx[i] = gi * dxs;
  }
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
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w][threadIdx.x];
    partial[(long long)blockIdx.x * L + threadIdx.x] = s;
  }
}

// One block of L warps: warp l adds column l of the (blocks, L) partial sums,
// lane j taking rows j, j + 32, ... in order, then the same shuffle tree.
__global__ void quantize_bwd_reduce_kernel(const float* __restrict__ partial,
                                           int blocks, int L,
                                           float* __restrict__ dcenters) {
  const int lane = threadIdx.x & 31, l = threadIdx.x >> 5;
  float s = 0.f;
  for (int b = lane; b < blocks; b += 32) s += partial[(long long)b * L + l];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) dcenters[l] = s;
}

// x, dx: n floats; g, gh: n floats or null; centers, dcenters: L floats;
// partial: blocks * L floats of scratch. ``blocks`` is the caller's, a
// function of n alone.
extern "C" int quantize_bwd(const float* x, const float* g, const float* gh,
                            long long n, const float* centers, int L,
                            float sigma, float* dx, float* dcenters,
                            float* partial, int blocks, cudaStream_t stream) {
  if (L < 1 || L > MAX_CENTERS || blocks < 1) return (int)cudaErrorInvalidValue;
  if (L <= 8) {  // every shipped config has L = 6
    quantize_bwd_kernel<8><<<blocks, THREADS, 0, stream>>>(
        x, g, gh, n, centers, L, sigma, dx, partial);
  } else {
    quantize_bwd_kernel<32><<<blocks, THREADS, 0, stream>>>(
        x, g, gh, n, centers, L, sigma, dx, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quantize_bwd_reduce_kernel<<<1, 32 * L, 0, stream>>>(partial, blocks, L, dcenters);
  return (int)cudaGetLastError();
}
