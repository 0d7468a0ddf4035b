// One depth plane's 2D wavefront, encode and decode (kernel 5 of the port).
//
// Replaces the TPU kernel imgcomp_cvpr_tpu/coding/planar_kernel.py::
// make_plane_forward (pl.pallas_call at :393): its enc_teacher variant
// (mode 1, teacher-forced, writes per-lane (freq, start)) and its dec_only
// variant (mode 0, the sequential 32-lane interleaved rANS decode with the
// per-plane tail-packing threshold). Both modes compute logits with the same
// code and their CDFs with cdf_from_logits (cdf.cuh, shared with kernel 2).
//
// Design. One thread block per image walks the T2 steps of the plane in
// order (coding/planar.py has the geometry). Cell (h, w) of level l is
// computed at step t = BH*h + w + CTR*l, so the cells of one step are
// worked out from t alone: no host tables. Activations of levels 1-3 live
// in device memory as whole (H_l, W_l, kf) grids per image (they are also
// the plane's outputs, which PlanarCoder's bias convolutions of the next
// planes read); the padded q plane (level 0) is filled with the pad value
// at the start and receives each symbol's center in the step that codes
// it. At step t the block computes the level 1..4 cells of the step, with a
// block barrier between levels (the centre tap of layers 2-4 and layer 3's
// skip read cells written earlier in the same step), each cell's sum over
// the layer's top-slice taps plus its bias row (the lower kernel slices
// over the known planes). Level 4 writes the band's logits to shared
// memory; then the step's <= 32 band symbols are one rANS chunk: in encode
// each lane selects its (freq, start); in decode warp 0 finds each lane's
// symbol, updates its state and pulls renorm words ranked with
// __ballot_sync/__popc exactly like rans.decode_step_interleaved, with no
// pull once a lane has decoded thresh symbols of this plane. Top-slice
// weights sit in shared memory.
//
// Numerics: every layer sum is accumulated in (tap, input channel) order
// with separate round-to-nearest multiplies and adds, then the bias row
// (and layer 3's skip) is added, so the plain PyTorch version
// (coding/planar_kernel.py) reproduces every logit bit for bit.
//
// Bound on the H100: operations; the top-slice taps of one Kodak-size plane
// (64 x 96, K=5, kf=24) are ~0.45 GFLOP per image in f32 (chip_smoke.py
// counts them). What really bounds it is the chain of T2 dependent steps x
// 5 barriered phases with one SM per image; this first version keeps the
// plain structure (no tensor cores, no split of an image over SMs).

#include <cuda_runtime.h>
#include <stdint.h>

#define R 32
#define MAX_L 16
#define MAX_TAPS 32
#define SCALE 65536u
#define RANS_L 65536u
#define THREADS 384

#include "cdf.cuh"

struct PlaneArgs {
  int mode, B, H, W, K, BH, CTR, T2, kf, L, cap;
  int nt[4];
  int tdy[4][MAX_TAPS];
  int tdx[4][MAX_TAPS];
  const float* params;
  const float *bias1, *bias2, *bias3, *bias4;
  float *act1, *act2, *act3, *qplane;
  const int* true_plane;
  int *fsel, *ssel;
  const int* streams;
  const int* states_in;
  const int* gptr_in;
  const int* thresh;
  int *syms_out, *states_out, *gptr_out;
};

// First band row of diagonal v in a (Hl, Wl) grid: cells (h, v - BH*h),
// h in [band_lo, band_hi].
__device__ __forceinline__ int band_lo(int v, int Wl, int BH) {
  const int e = v - (Wl - 1);
  return e > 0 ? (e + BH - 1) / BH : 0;
}

__device__ __forceinline__ int band_hi(int v, int Hl, int BH) {
  const int h = v / BH;
  return h < Hl - 1 ? h : Hl - 1;
}

// One level's cells of one step: every (cell, output channel). dst is the
// level's grid, or (band) the shared-memory logits indexed by h - h_lo.
__device__ __forceinline__ void level_phase(
    int v, int Hl, int Wl, int BH, const int* tdy, const int* tdx, int nt,
    const float* src, int Ws, int cin, const float* w, const float* bias, int cout,
    bool relu, const float* skip, int sk, int Wsk, float* dst, bool band) {
  if (v < 0) return;
  const int h_lo = band_lo(v, Wl, BH);
  const int nc = band_hi(v, Hl, BH) - h_lo + 1;
  for (int it = threadIdx.x; it < nc * cout; it += blockDim.x) {
    const int h = h_lo + it / cout, c = it % cout;
    const int wc = v - BH * h;
    float acc = 0.f;
    for (int k = 0; k < nt; ++k) {
      const float* x = src + ((size_t)(h + tdy[k]) * Ws + (wc + tdx[k])) * cin;
      const float* wk = w + k * cin * cout + c;
      // Explicit round-to-nearest mul and add (no FMA contraction): the
      // plain version repeats exactly this sequence of roundings.
      for (int ci = 0; ci < cin; ++ci)
        acc = __fadd_rn(acc, __fmul_rn(x[ci], wk[ci * cout]));
    }
    acc = __fadd_rn(acc, bias[((size_t)h * Wl + wc) * cout + c]);
    if (skip) acc = __fadd_rn(acc, skip[((size_t)(h + sk) * Wsk + (wc + sk)) * cout + c]);
    if (relu) acc = fmaxf(acc, 0.f);
    if (band)
      dst[(h - h_lo) * cout + c] = acc;
    else
      dst[((size_t)h * Wl + wc) * cout + c] = acc;
  }
}

__host__ __device__ inline int params_size(const int* nt, int kf, int L) {
  return nt[0] * kf + (nt[1] + nt[2]) * kf * kf + nt[3] * kf * L + 1 + L;
}

__global__ void __launch_bounds__(THREADS) plane_kernel(PlaneArgs a) {
  extern __shared__ float sm[];
  __shared__ float lg[R * MAX_L];
  const int b = blockIdx.x, kf = a.kf, L = a.L, K = a.K, BH = a.BH;
  const int half = K / 2, reach = 4 * half;
  int Hl[5], Wl[5];
  for (int l = 0; l < 5; ++l) {
    Hl[l] = a.H + 2 * (4 - l) * half;
    Wl[l] = a.W + 2 * (4 - l) * half;
  }
  const int np = params_size(a.nt, kf, L);
  for (int i = threadIdx.x; i < np; i += blockDim.x) sm[i] = a.params[i];
  const float* w1 = sm;
  const float* w2 = w1 + a.nt[0] * kf;
  const float* w3 = w2 + a.nt[1] * kf * kf;
  const float* w4 = w3 + a.nt[2] * kf * kf;
  const float* padp = w4 + a.nt[3] * kf * L;
  const float* centers = padp + 1;

  const int HW = a.H * a.W;
  float* q = a.qplane + (size_t)b * Hl[0] * Wl[0];
  float* act1 = a.act1 + (size_t)b * Hl[1] * Wl[1] * kf;
  float* act2 = a.act2 + (size_t)b * Hl[2] * Wl[2] * kf;
  float* act3 = a.act3 + (size_t)b * Hl[3] * Wl[3] * kf;
  const float* bias1 = a.bias1 + (size_t)b * Hl[1] * Wl[1] * kf;
  const float* bias2 = a.bias2 + (size_t)b * Hl[2] * Wl[2] * kf;
  const float* bias3 = a.bias3 + (size_t)b * Hl[3] * Wl[3] * kf;
  const float* bias4 = a.bias4 + (size_t)b * HW * L;
  const float pad = a.params[np - 1 - L];
  for (int i = threadIdx.x; i < Hl[0] * Wl[0]; i += blockDim.x) q[i] = pad;

  const int lane = threadIdx.x & 31;
  const bool rans_warp = (a.mode == 0) && threadIdx.x < 32;
  uint32_t st = 0, gptr = 0;
  int cnt = 0, thr = 0;
  const int* stream = a.streams + (size_t)b * a.cap;
  if (rans_warp) {
    st = (uint32_t)a.states_in[b * R + lane];
    gptr = (uint32_t)a.gptr_in[b];
    thr = a.thresh[b * R + lane];
  }
  __syncthreads();

  for (int t = 0; t < a.T2; ++t) {
    level_phase(t - a.CTR, Hl[1], Wl[1], BH, a.tdy[0], a.tdx[0], a.nt[0], q, Wl[0], 1,
                w1, bias1, kf, true, nullptr, 0, 0, act1, false);
    __syncthreads();
    level_phase(t - 2 * a.CTR, Hl[2], Wl[2], BH, a.tdy[1], a.tdx[1], a.nt[1], act1,
                Wl[1], kf, w2, bias2, kf, true, nullptr, 0, 0, act2, false);
    __syncthreads();
    level_phase(t - 3 * a.CTR, Hl[3], Wl[3], BH, a.tdy[2], a.tdx[2], a.nt[2], act2,
                Wl[2], kf, w3, bias3, kf, false, act1, K - 1, Wl[1], act3, false);
    __syncthreads();
    const int v4 = t - 4 * a.CTR;
    level_phase(v4, Hl[4], Wl[4], BH, a.tdy[3], a.tdx[3], a.nt[3], act3, Wl[3], kf,
                w4, bias4, L, true, nullptr, 0, 0, lg, true);
    __syncthreads();

    // The step's band: lane r = level-4 cell h_lo + r.
    int h_lo = 0, nband = 0;
    if (v4 >= 0) {
      h_lo = band_lo(v4, a.W, BH);
      nband = band_hi(v4, a.H, BH) - h_lo + 1;
    }
    if (a.mode == 1) {
      if (threadIdx.x < R) {
        const int r = threadIdx.x;
        int fs = 0, ss = 0;
        if (r < nband) {
          const int h = h_lo + r, wc = v4 - BH * h;
          int freq[MAX_L], cdf[MAX_L];
          cdf_from_logits(lg + r * L, L, freq, cdf);
          const int sym = a.true_plane[(size_t)b * HW + h * a.W + wc];
          fs = freq[sym];
          ss = cdf[sym];
          q[(h + reach) * Wl[0] + wc + reach] = centers[sym];
        }
        const size_t o = ((size_t)b * a.T2 + t) * R + r;
        a.fsel[o] = fs;
        a.ssel[o] = ss;
      }
    } else if (rans_warp) {
      const bool act = lane < nband;
      const int h = h_lo + lane, wc = v4 - BH * h;
      int freq[MAX_L], cdf[MAX_L];
      int sym = 0;
      uint32_t x = st;
      if (act) {
        cdf_from_logits(lg + lane * L, L, freq, cdf);
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
        a.syms_out[(size_t)b * HW + h * a.W + wc] = sym;
        q[(h + reach) * Wl[0] + wc + reach] = centers[sym];
      }
      gptr += (uint32_t)__popc(mask);
    }
    __syncthreads();
  }
  if (rans_warp) {
    a.states_out[b * R + lane] = (int)st;
    if (lane == 0) a.gptr_out[b] = (int)gptr;
  }
}

extern "C" int plane_forward(PlaneArgs a, cudaStream_t stream) {
  if (a.L < 2 || a.L > MAX_L || a.kf < 1 || a.B < 1) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < 4; ++l)
    if (a.nt[l] < 1 || a.nt[l] > MAX_TAPS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)params_size(a.nt, a.kf, a.L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      plane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  plane_kernel<<<a.B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
