// K=3 wavefront forward scan, encode and decode (kernel 2 of the port).
//
// Replaces the TPU kernel imgcomp_cvpr_tpu/coding/pallas_kernel.py::
// make_forward (pl.pallas_call at :1089): its enc_parallel variant (mode 1,
// teacher-forced, writes per-symbol (freq, start) in the chunk-major
// layout) and its dec_only variant (mode 0, the sequential 32-lane
// interleaved rANS decode inside the scan). The CDF quantizer
// _quantize_cdf_kernel (:547-563) is the __device__ function
// cdf_from_logits of cdf.cuh (shared with kernel 5), which both modes call
// on logits computed by the same code: that is what makes the port's
// streams decode bit-exactly.
//
// Design. One thread block per image walks the T wavefront steps in order.
// Activations of the three hidden layers live in device memory, one row of
// kf floats per cell of each layer's grid plus a constant row (the all-pad
// activation) that every tap of a pre-history cell points at; the host
// precomputes, per layer, the cells of each step and each cell's source row
// per unmasked tap (coding/cuda_kernel.py). At step t the block computes
// layer 1..4 cells of that step (a block barrier between layers: the centre
// tap of layers 2-4 reads the cell the previous phase just wrote), then the
// step's rANS lanes. Folded weights (unmasked taps only) sit in shared
// memory. Decode runs on warp 0: per sub-iteration the 32 lanes find their
// symbol, update the state and pull renorm words, ranked with
// __ballot_sync/__popc exactly like rans.decode_step_interleaved.
//
// Numerics: every layer sum is accumulated in (tap, input channel) order
// with separate round-to-nearest multiplies and adds, so the plain PyTorch
// version (coding/cuda_kernel.py) reproduces the logits bit for bit on the
// card and the two agree on every table entry.
//
// Bound on the H100: operations, ~8.1 GFLOP per Kodak-size image in f32
// over the unmasked taps of the four layer grids at kf=24 (chip_smoke.py
// counts them: a 1.94 ms bound for B=16 at 67 TFLOP/s, measured 252 ms on
// an H100 80GB HBM3 at 700 W); what really bounds it is the chain of T dependent
// steps x 4 layer phases with one SM per image and the latency of each
// phase's tap gathers. This first version keeps the plain structure (no
// tensor cores, no multi-SM split of an image); making it fast is later
// work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define R 32
#define MAX_L 16
#define NT1 13
#define NTO 14
#define SCALE 65536u
#define RANS_L 65536u
#define THREADS 1024

#include "cdf.cuh"

struct FwdArgs {
  int mode, B, T, n, kf, L, CQ, cap, G1, G2, G3;
  const float* params;
  const int *ptr1, *cells1, *taps1;
  const int *ptr2, *cells2, *taps2;
  const int *ptr3, *cells3, *taps3;
  const int *ptr4, *cells4, *taps4;
  const int* skip3;
  const int* idx_cm;
  float *act1, *act2, *act3, *logits, *qbuf;
  const int* true_syms;
  int *fsel, *ssel;
  const int* streams;
  const int* init_states;
  const int* thresh;
  int* syms_out;
};

// One layer phase of step t: every (cell of the step, output channel).
__device__ __forceinline__ void layer_phase(
    int t, const int* __restrict__ ptr, const int* __restrict__ cells,
    const int* __restrict__ taps, int ntaps, const float* src, int cin,
    const float* w, const float* bias, int cout, float* dst, bool relu,
    const float* skip_src, const int* __restrict__ skip_idx) {
  const int c0 = ptr[t];
  const int items = (ptr[t + 1] - c0) * cout;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int j = c0 + it / cout;
    const int c = it % cout;
    const int* tp = taps + (size_t)j * ntaps;
    float acc = 0.f;
    for (int k = 0; k < ntaps; ++k) {
      const float* x = src + (size_t)tp[k] * cin;
      const float* wk = w + k * cin * cout + c;
      // Explicit round-to-nearest mul and add (no FMA contraction): the
      // plain version repeats exactly this sequence of roundings.
      for (int ci = 0; ci < cin; ++ci)
        acc = __fadd_rn(acc, __fmul_rn(x[ci], wk[ci * cout]));
    }
    acc = __fadd_rn(acc, bias[c]);
    if (skip_src) acc = __fadd_rn(acc, skip_src[(size_t)skip_idx[j] * cout + c]);
    if (relu) acc = fmaxf(acc, 0.f);
    dst[(size_t)cells[j] * cout + c] = acc;
  }
}

__host__ __device__ inline int params_size(int kf, int L) {
  return NT1 * kf + kf + 2 * (NTO * kf * kf + kf) + NTO * kf * L + L + 3 * kf + 1 + L;
}

__global__ void __launch_bounds__(THREADS) wavefront_kernel(FwdArgs a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, kf = a.kf, L = a.L, n = a.n;
  const int np = params_size(kf, L);
  for (int i = threadIdx.x; i < np; i += blockDim.x) sm[i] = a.params[i];
  const float* w1 = sm;
  const float* b1 = w1 + NT1 * kf;
  const float* w2 = b1 + kf;
  const float* b2 = w2 + NTO * kf * kf;
  const float* w3 = b2 + kf;
  const float* b3 = w3 + NTO * kf * kf;
  const float* w4 = b3 + kf;
  const float* b4 = w4 + NTO * kf * L;
  const float* k1 = b4 + L;
  const float* k2 = k1 + kf;
  const float* k3 = k2 + kf;
  const float* pad = k3 + kf;
  const float* centers = pad + 1;
  __syncthreads();

  float* act1 = a.act1 + (size_t)b * (a.G1 + 1) * kf;
  float* act2 = a.act2 + (size_t)b * (a.G2 + 1) * kf;
  float* act3 = a.act3 + (size_t)b * (a.G3 + 1) * kf;
  float* qb = a.qbuf + (size_t)b * (n + 1);
  float* lg = a.logits + (size_t)b * n * L;
  for (int c = threadIdx.x; c < kf; c += blockDim.x) {
    act1[(size_t)a.G1 * kf + c] = k1[c];
    act2[(size_t)a.G2 * kf + c] = k2[c];
    act3[(size_t)a.G3 * kf + c] = k3[c];
  }
  if (threadIdx.x == 0) qb[n] = pad[0];

  const int lane = threadIdx.x & 31;
  const bool rans_warp = (a.mode == 0) && threadIdx.x < 32;
  uint32_t st = 0, gptr = 0;
  int cnt = 0, thr = 0;
  const int* stream = a.streams + (size_t)b * a.cap;
  if (rans_warp) {
    st = (uint32_t)a.init_states[b * R + lane];
    thr = a.thresh[b * R + lane];
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    layer_phase(t, a.ptr1, a.cells1, a.taps1, NT1, qb, 1, w1, b1, kf, act1, true,
                nullptr, nullptr);
    __syncthreads();
    layer_phase(t, a.ptr2, a.cells2, a.taps2, NTO, act1, kf, w2, b2, kf, act2, true,
                nullptr, nullptr);
    __syncthreads();
    layer_phase(t, a.ptr3, a.cells3, a.taps3, NTO, act2, kf, w3, b3, kf, act3, false,
                act1, a.skip3);
    __syncthreads();
    layer_phase(t, a.ptr4, a.cells4, a.taps4, NTO, act3, kf, w4, b4, L, lg, true,
                nullptr, nullptr);
    __syncthreads();

    const int* idx_row = a.idx_cm + (size_t)t * a.CQ;
    if (a.mode == 1) {
      // Teacher-forced encode: the tables do not depend on rANS state, so
      // every lane of the step is independent.
      const size_t out_row = ((size_t)b * a.T + t) * a.CQ;
      for (int cq = threadIdx.x; cq < a.CQ; cq += blockDim.x) {
        const int idx = idx_row[cq];
        int fs = 0, ss = 0;
        if (idx < n) {
          int freq[MAX_L], cdf[MAX_L];
          cdf_from_logits(lg + (size_t)idx * L, L, freq, cdf);
          const int sym = a.true_syms[(size_t)b * n + idx];
          fs = freq[sym];
          ss = cdf[sym];
          qb[idx] = centers[sym];
        }
        a.fsel[out_row + cq] = fs;
        a.ssel[out_row + cq] = ss;
      }
    } else if (rans_warp) {
      for (int si = 0; si < a.CQ / R; ++si) {
        const int idx = idx_row[si * R + lane];
        const bool act = idx < n;
        int freq[MAX_L], cdf[MAX_L];
        int sym = 0;
        uint32_t x = st;
        if (act) {
          cdf_from_logits(lg + (size_t)idx * L, L, freq, cdf);
          const uint32_t slot = st & (SCALE - 1u);
          sym = -1;
          for (int l = 0; l < L; ++l) sym += ((uint32_t)cdf[l] <= slot) ? 1 : 0;
          x = (uint32_t)freq[sym] * (st >> 16) + slot - (uint32_t)cdf[sym];
        }
        const bool need = act && x < RANS_L && cnt < thr;
        cnt += act ? 1 : 0;
        const unsigned mask = __ballot_sync(0xffffffffu, need);
        if (need) {
          int pos = (int)gptr + __popc(mask & ((1u << lane) - 1u));
          pos = pos < 0 ? 0 : (pos >= a.cap ? a.cap - 1 : pos);
          x = (x << 16) | ((uint32_t)stream[pos] & 0xFFFFu);
        }
        if (act) {
          st = x;
          a.syms_out[(size_t)b * n + idx] = sym;
          qb[idx] = centers[sym];
        }
        gptr += (uint32_t)__popc(mask);
      }
    }
    __syncthreads();
  }
}

extern "C" int wavefront_forward(FwdArgs a, cudaStream_t stream) {
  if (a.L < 2 || a.L > MAX_L || a.kf < 1 || a.CQ % R != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)params_size(a.kf, a.L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wavefront_kernel<<<a.B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
