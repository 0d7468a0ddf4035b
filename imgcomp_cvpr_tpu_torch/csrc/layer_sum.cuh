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
// activation row once (float4s for float rows of a multiple of 4) and the
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
// Typed operands (kernel 2's precisions; pallas_kernel.py make_forward's
// ring_dt). At precision P the activations that later layers read as taps
// are stored as Operand<P>::T, rounded once where they are written
// (to_operand): float32 at 0 (the only precision kernel 5 has), bfloat16 at
// 1, float8_e4m3fn at 2. The sums read rows through their storage type
// (what `row` returns): a float row is the float32 code; a bf16 or e4m3 row
// of whole 32-bit words is loaded as raw words, 8 or 16 operands a 128-bit
// load, and each operand is widened to float exactly (a bf16 by a shift, an
// e4m3 pair by the hardware convert to half2) where the sum uses it: a
// convert right after the load would wait for it there and take away the D
// taps' rows in flight. Products of the widened inputs and the (host-rounded) weights are
// exact in float32, so the sum keeps its one order, and the values are those
// that rounding a float32 activation where the sum uses it gave.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

template <int P> struct Operand { using T = float; };
template <> struct Operand<1> { using T = __nv_bfloat16; };
template <> struct Operand<2> { using T = __nv_fp8_storage_t; };

// x rounded to P's type as stored: round to nearest even (e4m3 with its
// subnormals), and NaN where e4m3fn overflows (|x| > 464 rounds past its
// largest finite value, 448), as XLA's non-saturating convert gives; the
// hardware convert saturates, so the overflow is set apart.
template <int P>
__device__ __forceinline__ typename Operand<P>::T to_operand(float x) {
  if constexpr (P == 1) {
    return __float2bfloat16_rn(x);
  } else if constexpr (P == 2) {
    return fabsf(x) > 464.f ? (__nv_fp8_storage_t)0x7f
                            : __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  } else {
    return x;
  }
}

// One stored operand as float, exactly.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(x) << 16);
}
__device__ __forceinline__ float widen(__nv_fp8_storage_t x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}

// Operands 2c and 2c + 1 of a row held as raw words (bf16: word c; e4m3: a
// half of word c / 2).
template <class T>
__device__ __forceinline__ float2 widen_pair(const uint32_t* w, int c) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return make_float2(__uint_as_float(w[c] << 16), __uint_as_float(w[c] & 0xffff0000u));
  } else {
    const uint32_t v = (c & 1) ? w[c / 2] >> 16 : w[c / 2] & 0xffffu;
    return __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)v, __NV_E4M3)));
  }
}

template <bool CG, class T>
__device__ __forceinline__ T load_x(const T* p) {
  if constexpr (CG) return __ldcg(p);
  else return *p;
}

// A row of BYTES (a multiple of 4) as 32-bit words, in the widest loads its
// size allows (a row starts at a multiple of its size's vector width).
template <int BYTES, bool CG>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  static_assert(BYTES % 4 == 0, "a typed row is whole 32-bit words");
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 v = load_x<CG>(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  } else if constexpr (BYTES % 8 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 8; ++i) {
      const uint2 v = load_x<CG>(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = v.x; w[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i)
      w[i] = load_x<CG>(reinterpret_cast<const uint32_t*>(p) + i);
  }
}

// CIN contiguous stored operands of one activation row: float4s for a float
// row of a multiple of 4, else one at a time.
template <int CIN, bool CG, class T>
__device__ __forceinline__ void load_row(const T* p, T (&x)[CIN]) {
  if constexpr (std::is_same_v<T, float> && CIN % 4 == 0) {
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
    for (int i = 0; i < CIN; ++i) x[i] = load_x<CG>(p + i);
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
// stored inputs of cell m; w is [NT][CIN][COUT] in shared memory (or, past
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
template <int CIN, int COUT, int CO, int NT, int M, int D, bool CG, class Row>
__device__ __forceinline__ void cell_sum(float (&acc)[M][CO], Row row, const float* w,
                                         int c0) {
  using T = std::remove_cv_t<std::remove_pointer_t<decltype(row(0, 0))>>;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[m][j] = 0.f;
  if constexpr (std::is_same_v<T, float> || CIN * sizeof(T) % 4 != 0) {
    // float rows, and rows shorter than a word (layer 1's one q a tap at
    // precisions 1 and 2): the operands as stored, widened where used.
    T x[D][M][CIN];
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
            // Explicit round-to-nearest mul and add (no FMA contraction).
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const float xv = widen(x[d][m][ci]);
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
  } else {
    // bf16 / e4m3 rows of whole words: 8 / 16 operands a 128-bit load, two
    // input channels a step (the same (tap, channel) order per output).
    static_assert(CIN % 2 == 0, "typed rows hold channel pairs");
    constexpr int NW = CIN * (int)sizeof(T) / 4;
    uint32_t x[D][M][NW];
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < NT)
#pragma unroll
        for (int m = 0; m < M; ++m) load_words<(int)(CIN * sizeof(T)), CG>(row(m, d), x[d][m]);
#pragma unroll(D == 1 ? 2 : 1)
    for (int k0 = 0; k0 < NT; k0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int k = k0 + d;
        if (k < NT) {
          const float* wk = w + k * CIN * COUT + c0;
#pragma unroll
          for (int c = 0; c < CIN / 2; ++c) {
            float wa[CO], wb[CO];
            load_w<CO>(wk + 2 * c * COUT, wa);
            load_w<CO>(wk + (2 * c + 1) * COUT, wb);
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const float2 xv = widen_pair<T>(x[d][m], c);
#pragma unroll
              for (int j = 0; j < CO; ++j)
                acc[m][j] = __fadd_rn(acc[m][j], __fmul_rn(xv.x, wa[j]));
#pragma unroll
              for (int j = 0; j < CO; ++j)
                acc[m][j] = __fadd_rn(acc[m][j], __fmul_rn(xv.y, wb[j]));
            }
          }
          if (k + D < NT)
#pragma unroll
            for (int m = 0; m < M; ++m)
              load_words<(int)(CIN * sizeof(T)), CG>(row(m, k + D), x[d][m]);
        }
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
      dst[part] = load_x<CG>(row + part);
    }
  }
}

// Generic instance: output channel c of one cell, any widths; row(k) points
// at tap k's cin stored operands (float, bf16 or e4m3).
template <bool CG, class Row>
__device__ __forceinline__ float cell_sum_any(Row row, const float* w, int c, int cin,
                                              int cout, int nt) {
  float acc = 0.f;
  for (int k = 0; k < nt; ++k) {
    const auto* x = row(k);
    const float* wk = w + k * cin * cout + c;
    for (int ci = 0; ci < cin; ++ci)
      acc = __fadd_rn(acc, __fmul_rn(widen(load_x<CG>(x + ci)), wk[ci * cout]));
  }
  return acc;
}
