// The CDF quantizer shared by the port's forward kernels (kernel 2,
// wavefront_forward.cu, and kernel 5, plane_forward.cu).
//
// Replaces imgcomp_cvpr_tpu/coding/pallas_kernel.py::_quantize_cdf_kernel
// (:547-563), which both TPU forward kernels call (pallas_kernel.py:48-50,
// planar_kernel.py:206). Encode and decode compute their tables with this one
// function, which is what makes the streams decode bit-exactly. Its plain
// PyTorch twin is coding/cuda_kernel.py::logits_to_cdf.

#pragma once

#include <math.h>

#ifndef MAX_L
#define MAX_L 16
#endif
#ifndef SCALE
#define SCALE 65536u
#endif

// logits (L,) -> (freq, cdf_low) with sum(freq) == SCALE: softmax with a
// sequential sum, floor(p * (SCALE - L)) + 1, the deficit to the lowest
// index of the max probability, exclusive cumsum. NL > 0 fixes L at compile
// time (the loops unroll and the arrays stay in registers); NL == 0 takes
// the run-time L. The arithmetic is the same either way.
//
// Non-finite logits, as _quantize_cdf_kernel computes them op by op: a
// column holding a NaN or a +inf logit (inf - inf is NaN) has a NaN sum, so
// every p is NaN. (int)floorf(NaN) is 0 (PTX's cvt, as XLA converts), so
// each freq is 1; no p equals the column's max (NaN), so no symbol takes the
// deficit: freq 1 for every symbol, cdf_low l, a column summing to L. The
// rANS coders take such a column as it is (slot = start for freq 1). A -inf
// logit only gives its symbol p = 0 (a column of -inf alone is NaN). fmaxf
// skips a NaN where jnp.max returns it; the sum is NaN either way. The plain
// twin, coding/cuda_kernel.py::logits_to_cdf, states the same rule.
template <int NL>
__device__ __forceinline__ void cdf_from_logits(const float* lg, int L_rt, int* freq,
                                                int* cdf) {
  constexpr int N = NL > 0 ? NL : MAX_L;
  const int L = NL > 0 ? NL : L_rt;
  float m = lg[0];
#pragma unroll
  for (int l = 1; l < N; ++l)
    if (l < L) m = fmaxf(m, lg[l]);
  float e[N];
#pragma unroll
  for (int l = 0; l < N; ++l)
    if (l < L) e[l] = expf(lg[l] - m);
  float s = e[0];
#pragma unroll
  for (int l = 1; l < N; ++l)
    if (l < L) s = s + e[l];
  const float scale_l = (float)(SCALE - (unsigned)L);
  float pmax = -1.f;
  int am = L, total = 0;  // no symbol until a p beats pmax: none on a NaN column
#pragma unroll
  for (int l = 0; l < N; ++l) {
    if (l < L) {
      const float p = e[l] / s;
      const int f = (int)floorf(p * scale_l) + 1;
      freq[l] = f;
      total += f;
      if (p > pmax) { pmax = p; am = l; }
    }
  }
  const int deficit = (int)SCALE - total;
  int acc = 0;
#pragma unroll
  for (int l = 0; l < N; ++l) {
    if (l < L) {
      if (l == am) freq[l] += deficit;
      cdf[l] = acc;
      acc += freq[l];
    }
  }
}

// (freq[sym], cdf[sym]) without a dynamically indexed register array.
template <int NL>
__device__ __forceinline__ void cdf_select(const int* freq, const int* cdf, int L_rt,
                                           int sym, int* fs, int* ss) {
  constexpr int N = NL > 0 ? NL : MAX_L;
  const int L = NL > 0 ? NL : L_rt;
  int f = 0, s = 0;
#pragma unroll
  for (int l = 0; l < N; ++l)
    if (l < L && l == sym) { f = freq[l]; s = cdf[l]; }
  *fs = f;
  *ss = s;
}
