// The one layer sum of the port's forward kernels (kernel 2,
// wavefront_forward.cu, and kernel 5, plane_forward.cu), shared by their
// scans (encode oracle and decode) and their layer-parallel encode passes.
//
// Rule: one accumulator per output, acc = __fadd_rn(acc, __fmul_rn(x, w))
// over (tap, input channel) in that order, starting from 0; the caller then
// adds the bias (or bias row), layer 3's skip, and applies the ReLU. A logit
// is therefore a fixed function of its inputs whatever thread, block or
// launch computes it, and the plain PyTorch versions (coding/cuda_kernel.py
// ::_layer_step) repeat the same roundings.
//
// Instances. cell_sum<CIN, COUT, CO, NT, M, D, CG> has every width at compile
// time: a thread owns CO consecutive output channels of M cells, loads each
// activation row once as float4s (CIN a multiple of 4, or CIN == 1) and the
// CO weights of an input channel as one float4 / float2 / float, and keeps x,
// w and the M x CO accumulators in registers with the channel loop fully
// unrolled and the tap loop unrolled by two (the whole tap loop unrolled
// would be ~40 KB of straight-line code a layer, more than the instruction
// cache likes). The kernels instantiate it for the widths the configs use: 1 -> 24,
// 24 -> 24 and 24 -> 6, with 13 / 14 taps (K = 3) and 12 / 13 taps (K = 5).
// cell_sum_any is the generic instance for any other width: one output a
// call, run-time loops, one global and one shared load per multiply (what the
// first version of these kernels did everywhere; several times slower).
//
// CG = true reads the activations with __ldcg (L2 only): in the cluster scan
// another block of the cluster, on another SM, wrote them, and an L1 line
// could be stale. CG = false uses plain loads (one block per image, or a
// launch that only reads what earlier launches wrote).
//
// P is the type an activation is rounded to where the sum uses it (kernel
// 2's precisions; pallas_kernel.py make_forward's ring_dt): 0 none (float32,
// the only instance kernel 5 has), 1 bfloat16, 2 float8_e4m3fn. The
// products of the rounded inputs and the (host-rounded) weights are exact in
// float32, so the sum keeps its one order and only its inputs change.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

// x rounded to P's type and back: round to nearest even (e4m3 with its
// subnormals), and NaN where e4m3fn overflows (|x| > 464 rounds past its
// largest finite value, 448), as XLA's non-saturating convert gives; the
// hardware convert saturates, so the overflow is set apart.
template <int P>
__device__ __forceinline__ float round_operand(float x) {
  if constexpr (P == 1) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else if constexpr (P == 2) {
    const __half_raw h =
        __nv_cvt_fp8_to_halfraw(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3), __NV_E4M3);
    return fabsf(x) > 464.f ? __int_as_float(0x7fc00000) : __half2float(__half(h));
  } else {
    return x;
  }
}

template <bool CG>
__device__ __forceinline__ float load_f(const float* p) {
  if constexpr (CG) return __ldcg(p);
  else return *p;
}

// CIN contiguous floats of one activation row.
template <int CIN, bool CG>
__device__ __forceinline__ void load_row(const float* p, float (&x)[CIN]) {
  if constexpr (CIN % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < CIN / 4; ++i) {
      float4 v;
      if constexpr (CG) v = __ldcg(p4 + i);
      else v = p4[i];
      x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z; x[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CIN; ++i) x[i] = load_f<CG>(p + i);
  }
}

// CO contiguous weights (shared or device memory; p is aligned to CO's vector
// width).
template <int CO>
__device__ __forceinline__ void load_w(const float* p, float (&w)[CO]) {
  if constexpr (CO % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CO / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  } else if constexpr (CO % 2 == 0) {
#pragma unroll
    for (int i = 0; i < CO / 2; ++i) {
      const float2 v = reinterpret_cast<const float2*>(p)[i];
      w[2 * i] = v.x; w[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CO; ++i) w[i] = p[i];
  }
}

// acc[m][j] = sum over (tap k, channel ci) of x_{m,k}[ci] * w[k][ci][c0 + j]
// for M cells m and CO channels j. row(m, k) is the address of tap k's CIN
// input floats of cell m; w is [NT][CIN][COUT] in shared memory (or, past
// the shared-memory limit, in device memory: the same order). A thread
// that owns M cells uses every weight it loads M times: the kernels are
// bound by the shared-memory reads of the weights (measured on an H100: a
// 128-bit load by a warp costs the SM ~8 clocks whatever the lanes share),
// so M x CO register tiles are what brings them towards the f32 arithmetic rate.
// D is how many taps' input rows are in flight: before tap k is summed, the
// rows of taps k .. k + D - 1 have been requested. D = 1 serves a launch with
// many warps a scheduler (another warp runs while one waits); in the scan a
// scheduler has about one warp, a tap's arithmetic (~250 clocks) is shorter
// than a row's trip to L2, and D = 4 keeps the warp fed.
template <int CIN, int COUT, int CO, int NT, int M, int D, bool CG, int P = 0, class Row>
__device__ __forceinline__ void cell_sum(float (&acc)[M][CO], Row row, const float* w,
                                         int c0) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[m][j] = 0.f;
  float x[D][M][CIN];
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < NT)
#pragma unroll
      for (int m = 0; m < M; ++m) load_row<CIN, CG>(row(m, d), x[d][m]);
#pragma unroll(D == 1 ? 2 : 1)
  for (int k0 = 0; k0 < NT; k0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int k = k0 + d;
      if (k < NT) {
        const float* wk = w + k * CIN * COUT + c0;
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          float wv[CO];
          load_w<CO>(wk + ci * COUT, wv);
          // Explicit round-to-nearest mul and add (no FMA contraction). An
          // input is rounded to P's type where it is used, not where it is
          // loaded: a convert right after the load would wait for it there
          // and take away the D taps' rows in flight.
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const float xv = round_operand<P>(x[d][m][ci]);
#pragma unroll
            for (int j = 0; j < CO; ++j)
              acc[m][j] = __fadd_rn(acc[m][j], __fmul_rn(xv, wv[j]));
          }
        }
        if (k + D < NT)
#pragma unroll
          for (int m = 0; m < M; ++m) load_row<CIN, CG>(row(m, k + D), x[d][m]);
      }
    }
  }
}

// Staging. In a scan a step is a chain of dependent phases with few cells
// each, and a thread that fetches its taps one after another from device
// memory (L2) waits out one memory latency a tap: 13-14 latencies a phase,
// which is what the time of a step was made of. stage_rows has the whole
// block fetch all NT rows of up to `ncell` cells into shared memory at once
// (every load independent: one latency in all); after a __syncthreads,
// cell_sum reads its rows from there. A cell's rows take stage_stride floats:
// NT * CIN plus 4, so that the cells a warp works on fall in different banks.
template <int CIN, int NT>
__host__ __device__ constexpr int stage_stride() {
  return ((NT * CIN + 3) / 4) * 4 + 4;
}

// row_of(cell, k): address of tap k's CIN floats of the block's cell `cell`.
template <int CIN, int NT, bool CG, class RowOf>
__device__ __forceinline__ void stage_rows(float* xs, int ncell, RowOf row_of) {
  constexpr int V = CIN % 4 == 0 ? CIN / 4 : CIN;   // float4s or floats a row
  constexpr int S = stage_stride<CIN, NT>();
#pragma unroll 4
  for (int i = threadIdx.x; i < ncell * NT * V; i += blockDim.x) {
    const int cell = i / (NT * V), rem = i % (NT * V);
    const int k = rem / V, part = rem % V;
    const float* row = row_of(cell, k);
    float* dst = xs + cell * S + k * CIN;
    if constexpr (CIN % 4 == 0) {
      const float4* r4 = reinterpret_cast<const float4*>(row) + part;
      float4 v;
      if constexpr (CG) v = __ldcg(r4);
      else v = *r4;
      reinterpret_cast<float4*>(dst)[part] = v;
    } else {
      dst[part] = load_f<CG>(row + part);
    }
  }
}

// Generic instance: output channel c of one cell, any widths.
template <bool CG, int P = 0, class Row>
__device__ __forceinline__ float cell_sum_any(Row row, const float* w, int c, int cin,
                                              int cout, int nt) {
  float acc = 0.f;
  for (int k = 0; k < nt; ++k) {
    const float* x = row(k);
    const float* wk = w + k * cin * cout + c;
    for (int ci = 0; ci < cin; ++ci)
      acc = __fadd_rn(acc, __fmul_rn(round_operand<P>(load_f<CG>(x + ci)), wk[ci * cout]));
  }
  return acc;
}
