// K=3 wavefront forward, encode and decode (kernel 2 of the port).
//
// Replaces the TPU kernel imgcomp_cvpr_tpu/coding/pallas_kernel.py::
// make_forward (pl.pallas_call at :1089): its enc_parallel variant (the
// teacher-forced per-symbol (freq, start) tables in the chunk-major layout),
// its dec_only variant (the sequential 32-lane interleaved rANS decode inside
// the scan) and its shared mode-flag variant. The CDF quantizer
// _quantize_cdf_kernel (:547-563) is cdf_from_logits of cdf.cuh and every
// layer sum is cell_sum of layer_sum.cuh; encode and decode compute their
// logits and CDFs with these same two functions, which is what makes the
// port's streams decode bit-exactly.
//
// Geometry (coding/cuda_kernel.py): activations of the three hidden layers
// live in device memory, one row of kf floats per cell of each layer's grid
// plus a constant row (the all-pad activation) that every tap of a
// pre-history cell points at; the host precomputes, per layer, the cells
// sorted by wavefront step and each cell's source row per unmasked tap. The
// wrapper fills the constant rows and the pad entry of q.
//
// Two entries.
//
// wavefront_encode: the teacher-forced tables as layer-parallel passes over
// the whole card. All symbols are known, so a cell of layer l depends only
// on layer l-1, never on a step or a rANS state: one launch per layer covers
// all N_l cells of all B images (a thread owns M = 2 cells x CO = 4 output
// channels), then one launch over (B, T, CQ) turns the logits into the
// chunk-major (freq, start) tables. Five launches, no dependent chain.
//
// wavefront_forward: the scan over the T wavefront steps. Mode 0 is the
// decoder (q -> layer 1 -> 2 -> 3 -> 4 -> symbol -> q is a true recurrence);
// mode 1 is the teacher-forced scan kept as the consistency oracle of the
// layer-parallel encode (the counterpart of the TPU kernel's shared
// mode-flag variant). One image is split over a thread-block cluster of
// `cluster` blocks (1..8; the wrapper takes the largest size at which all
// images of the batch run at once): cell r of a step goes to block r % nb,
// the activations go through device memory (L2; read back with __ldcg),
// a cluster barrier stands between the phases, and rank 0 holds the rANS
// warp. No sum is split, so an image's bytes do not depend on the cluster
// size. Per step:
//   layer 1 | barrier | layer 2 | barrier | layer 3 (+ skip) | barrier |
//   layer 4 -> the step's logits into rank 0's shared memory (distributed
//   shared memory) | barrier | rank 0: all threads compute (freq, cdf) of
//   the step's CQ entries into shared memory, __syncthreads, warp 0 runs the
//   S sub-iterations (slot search, state update, renorm pulls ranked with
//   __ballot_sync/__popc, `cnt < thr` tail suppression, exactly like
//   rans.decode_step_interleaved), q and the symbols go to device memory |
//   barrier.
// That is five cluster barriers a step and each stands on the recurrence:
// the centre tap of layers 2-4 and layer 3's skip read a cell that the phase
// before wrote in the same step, the CDFs need all logits of the step, and
// layer 1 of step t+1 reads the q of step t. Barriers the first version had
// and the data flow does not need are gone: the one between the logits and a
// separate CDF pass over device memory (the logits never leave the chip), and
// in mode 1 the one after the table write (the q write is ordered by the
// step's last barrier). What is static is kept off the chain: the layers'
// step pointers sit in shared memory, and between arriving at a barrier and
// waiting on it a block prefetches the index tables (taps, cells, skip,
// idx_cm) of the next step into its L1. The stream words come through a
// 128-word window in shared memory, refilled 64 words at a time, so a
// sub-iteration waits for shared memory and not for device memory
// (rans_window.cuh). An optional profile (FwdArgs::prof) sums the clocks of
// each phase and barrier.
//
// What bounds a phase (measured, see PERF.md): the rate at which an SM
// delivers loaded operands to registers, about 8 clocks for a warp's 128-bit
// load whatever the lanes share, so ~240 clocks of that pipe for a tap of a
// warp of 4-channel items and ~13,000 clocks for a 24 -> 24 phase on a
// cluster of 8. Staging the tap rows in shared memory (layer_sum.cuh's
// stage_rows, which kernel 5 uses) and one or two channels a thread were
// tried here and were slower.
//
// Template instances: <KF = 24, NL = 6> (`pc cvpr/res_shallow`: layers 1 ->
// 24, 24 -> 24 with 13 / 14 taps in registers, CO = 4 channels a thread with
// float4 loads; 24 -> 6 with CO = 2), <KF = 64, NL = 6> (`pc
// cvpr/res_shallow_64`, the same tiles) and <0, 0>, the generic instance for
// any other width (one (cell, channel) a thread, run-time loops, two loads per
// multiply: the first version's inner loop).
//
// Where the weights live (WG). The packed weights of all four layers go to a
// block's dynamic shared memory while they fit beside what else the entry
// keeps there: up to kf ~38 at L = 6 in the scan (its step tables and
// pointers take ~47 KB at the Kodak latent), ~43 in the encode. Past the
// card's opt-in limit (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB on an
// H100) all of them stay in device memory and are read through L1 / L2
// (kf = 64: 474 KB of weights against a 50 MB L2). The host picks the
// instance (choose_scan, encode_wdev); only where an operand comes from
// changes, not the order of any sum, so the tables and streams are the same
// bits with either placement. FwdArgs::force can ask for the device-memory
// placement or the generic instance where they are not needed (tests, and
// the comparisons that chip_smoke.py prints).
//
// Precisions (FwdArgs::prec, the container's prec byte; template P). The TPU
// kernel's prec f32 / bf16 / f8 (make_forward's cdt, ring_dt and r0_dt) are
// three instances of every entry. At 1 (bf16) and 2 (f8) the host rounds the
// weights and layer 1's q operands (centers, pad value) to bfloat16 and the
// all-pad constants to the ring's type once (cuda_kernel.operand_weights).
// The operands are stored at their precision (layer_sum.cuh's Operand<P>):
// q as bfloat16, the activations of layers 1-3 as bfloat16 or
// float8_e4m3fn, each rounded once where it is written (to_operand; the host
// writes the constant rows already rounded), so layers 2-4 read 8 or 16 tap
// inputs a 128-bit load and convert nothing but the exact widening. Layer
// 3's skip reads layer 1's float32 output (pallas_kernel.py:828, 836): layer
// 1 also writes a float32 copy of its rows (act1f), which the skip reads.
// Products of bf16 values are exact in float32, so the (tap, channel) order
// of every sum is that of precision 0, whose instance is the code it was
// before the other two existed, one buffer of float32 a layer
// (act1f == act1).
//
// Bound on the H100: operations, ~8.1 GFLOP per Kodak-size image in f32
// over the unmasked taps of the four layer grids at kf=24 (chip_smoke.py
// counts them and prints the measured times). The decode's second figure is
// its chain floor: 13 + 3 * 14 * 24 = 1021 dependent adds a step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define R 32
#define MAX_L 16
#define NT1 13
#define NTO 14
#define SCALE 65536u
#define RANS_L 65536u
#define THREADS 256
#define FORCE_WDEV 1      // weights in device memory even where they fit
#define FORCE_GENERIC 2   // the generic instance even where a fixed one exists

#include "cdf.cuh"
#include "layer_sum.cuh"
#include "rans_window.cuh"

struct FwdArgs {
  int mode, B, T, n, kf, L, CQ, cap, G1, G2, G3, cluster;
  int N1, N2, N3, N4;
  int force;         // FORCE_WDEV | FORCE_GENERIC, or 0: the host's own choice
  int prec;          // operand precision, the container's prec byte (0, 1, 2)
  const float* params;
  const int *ptr1, *cells1, *taps1;
  const int *ptr2, *cells2, *taps2;
  const int *ptr3, *cells3, *taps3;
  const int *ptr4, *cells4, *taps4;
  const int* skip3;
  const int* slot4;
  const int* idx_cm;
  void *act1, *act2, *act3;   // Operand<P>::T rows: what layers 2-4 read as taps
  float* act1f;               // layer 1 in float32 for layer 3's skip (act1 at P = 0)
  float* logits;
  void* qbuf;                 // q: float32 at P = 0, bfloat16 at 1 and 2
  const int* true_syms;
  int *fsel, *ssel;
  const int* streams;
  const int* init_states;
  const int* thresh;
  int* syms_out;
  long long* prof;   // optional (B, 10) clock sums of block 0's thread 0, or null
};

__host__ __device__ inline int params_size(int kf, int L) {
  return NT1 * kf + kf + 2 * (NTO * kf * kf + kf) + NTO * kf * L + L + 3 * kf + 1 + L;
}

struct Params {
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4, *pad, *centers;
};

// Slice the packed weights: copied into shared memory, or (WG) read where
// they are, in device memory.
template <bool WG>
__device__ __forceinline__ Params load_params(float* sm, const float* src, int kf, int L) {
  const float* base = src;
  if constexpr (!WG) {
    const int np = params_size(kf, L);
    for (int i = threadIdx.x; i < np; i += blockDim.x) sm[i] = src[i];
    base = sm;
  }
  Params p;
  p.w1 = base;
  p.b1 = p.w1 + NT1 * kf;
  p.w2 = p.b1 + kf;
  p.b2 = p.w2 + NTO * kf * kf;
  p.w3 = p.b2 + kf;
  p.b3 = p.w3 + NTO * kf * kf;
  p.w4 = p.b3 + kf;
  p.b4 = p.w4 + NTO * kf * L;
  p.pad = p.b4 + L + 3 * kf;
  p.centers = p.pad + 1;
  return p;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// Cells [c0, c0 + nc) of one layer's sorted cell list: every (cell, group
// of CO output channels) is one work item. The sum is cell_sum (or its
// generic instance when CIN == 0); then bias, layer 3's skip, ReLU.
// emit(out_idx[j], first channel, value array, count) stores cell j.
// CYCLIC = false (the layer-parallel encode): the items are dealt over all
// `nb` blocks' threads in order. CYCLIC = true (the scan): cell r goes to
// block r % nb, so every block of the cluster gets its share of a step's few
// cells.
template <int CIN, int COUT, int CO, int NT, int M, int D, bool CYCLIC, class Src, class Emit>
__device__ __forceinline__ void layer_cells(
    int c0, int nc, const int* __restrict__ taps, const int* __restrict__ out_idx,
    const Src* src, int cin, const float* w, const float* bias, int cout, bool relu,
    const float* skip_src, const int* __restrict__ skip_idx, int rank, int nb, Emit emit) {
  const int groups = CIN > 0 ? COUT / CO : cout;
  const int mine = CYCLIC ? (nc - rank + nb - 1) / nb : nc;
  const int units = (mine + M - 1) / M;          // M of the block's cells a thread
  const int first = CYCLIC ? threadIdx.x : rank * blockDim.x + threadIdx.x;
  const int stride = CYCLIC ? blockDim.x : nb * blockDim.x;
  for (int it = first; it < units * groups; it += stride) {
    const int u = it / groups, ch = (it % groups) * CO;
    int j[M], out[M];
    const int* tp[M];
    float sk[M][CO];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      // A unit's missing cells (the list's ragged end) repeat its first.
      const int r = u * M + m < mine ? u * M + m : u * M;
      j[m] = CYCLIC ? c0 + rank + r * nb : c0 + r;
      tp[m] = taps + (size_t)j[m] * NT;
      // Requested before the sum, so their latency hides behind it.
      out[m] = out_idx[j[m]];
#pragma unroll
      for (int i = 0; i < CO; ++i)
        sk[m][i] = skip_src
            ? __ldcg(skip_src + (size_t)skip_idx[j[m]] * groups * CO + ch + i) : 0.f;
    }
    float acc[M][CO];
    if constexpr (CIN > 0) {
      cell_sum<CIN, COUT, CO, NT, M, D, true>(
          acc, [&](int m, int k) { return src + (size_t)tp[m][k] * CIN; }, w, ch);
    } else {
      acc[0][0] = cell_sum_any<true>([&](int k) { return src + (size_t)tp[0][k] * cin; },
                                     w, ch, cin, cout, NT);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (u * M + m >= mine) break;
#pragma unroll
      for (int i = 0; i < CO; ++i) {
        float v = __fadd_rn(acc[m][i], bias[ch + i]);
        if (skip_src) v = __fadd_rn(v, sk[m][i]);
        acc[m][i] = relu && v < 0.f ? 0.f : v;  // NaN stays NaN (jax.nn.relu)
      }
      emit(out[m], ch, acc[m], CO);
    }
  }
}

// What layer_cells<CYCLIC = true> will read of its index tables for cells
// [c0, c0 + nc): into this SM's L1, a step ahead (the tables are static).
__device__ __forceinline__ void prefetch_cells(int c0, int nc, const int* taps, int nt,
                                               const int* out_idx, const int* skip_idx,
                                               int rank, int nb) {
  const int mine = (nc - rank + nb - 1) / nb;
  for (int r = threadIdx.x; r < mine; r += blockDim.x) {
    const int j = c0 + rank + r * nb;
    prefetch_l1(taps + (size_t)j * nt);
    prefetch_l1(taps + (size_t)j * nt + nt - 1);
    prefetch_l1(out_idx + j);
    if (skip_idx) prefetch_l1(skip_idx + j);
  }
}

// Store CO (or 1) channels of activation row `row`.
struct StoreRow {
  float* dst;
  int width;
  __device__ __forceinline__ void operator()(int row, int ch, const float* v, int n) const {
    float* p = dst + (size_t)row * width + ch;
    if (n == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if (n == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      for (int i = 0; i < n; ++i) p[i] = v[i];
    }
  }
};

// The same at precision P > 0: the channels rounded to Operand<P>::T (4 of
// them one 8- or 4-byte store), and with `f32` also as float32 (layer 1's
// copy for the skip).
template <int P>
struct StoreTyped {
  using T = typename Operand<P>::T;
  T* dst;
  int width;
  float* f32;
  __device__ __forceinline__ void operator()(int row, int ch, const float* v, int n) const {
    T* p = dst + (size_t)row * width + ch;
    if (n == 4) {
      if constexpr (P == 1) {
        const __nv_bfloat162 lo = __halves2bfloat162(to_operand<1>(v[0]), to_operand<1>(v[1]));
        const __nv_bfloat162 hi = __halves2bfloat162(to_operand<1>(v[2]), to_operand<1>(v[3]));
        *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                  *reinterpret_cast<const uint32_t*>(&hi));
      } else {
        *reinterpret_cast<uint32_t*>(p) =
            (uint32_t)to_operand<2>(v[0]) | ((uint32_t)to_operand<2>(v[1]) << 8) |
            ((uint32_t)to_operand<2>(v[2]) << 16) | ((uint32_t)to_operand<2>(v[3]) << 24);
      }
    } else {
      for (int i = 0; i < n; ++i) p[i] = to_operand<P>(v[i]);
    }
    if (f32) StoreRow{f32, width}(row, ch, v, n);
  }
};

// q's storage: float32 at precision 0, else bfloat16 (the host rounds the
// centers and the pad value it is made of to bfloat16).
template <int P>
using QType = typename Operand<P ? 1 : 0>::T;

// Layer l (1..3) over cells [c0, c0 + nc) of its list; CO channels a thread
// (1 in the generic instance, KF == 0). Every layer reads its taps as stored
// (q, then layers 1 and 2 at P's type) and writes its rows rounded to P's
// type; layer 1 also writes them in float32 at P > 0, for layer 3's skip
// (pallas_kernel.py:828, 836).
template <int KF, int CO, int M, int D, bool CYCLIC, int P>
__device__ __forceinline__ void hidden_layer(const FwdArgs& a, const Params& p, int l,
                                             int b, int c0, int nc, int rank, int nb) {
  using A = typename Operand<P>::T;
  const int kf = KF ? KF : a.kf;
  A* act1 = static_cast<A*>(a.act1) + (size_t)b * (a.G1 + 1) * kf;
  A* act2 = static_cast<A*>(a.act2) + (size_t)b * (a.G2 + 1) * kf;
  A* act3 = static_cast<A*>(a.act3) + (size_t)b * (a.G3 + 1) * kf;
  // At P = 0 the skip reads act1 itself (the one float32 buffer).
  float* act1f = P ? a.act1f + (size_t)b * (a.G1 + 1) * kf : reinterpret_cast<float*>(act1);
  const QType<P>* qb = static_cast<const QType<P>*>(a.qbuf) + (size_t)b * (a.n + 1);
  auto store = [&](A* dst, float* f32) {
    if constexpr (P == 0) return StoreRow{dst, kf};
    else return StoreTyped<P>{dst, kf, f32};
  };
  if (l == 1) {
    layer_cells<(KF ? 1 : 0), KF, CO, NT1, M, D, CYCLIC>(
        c0, nc, a.taps1, a.cells1, qb, 1, p.w1, p.b1, kf, true, nullptr, nullptr, rank, nb,
        store(act1, P ? act1f : nullptr));
  } else {
    // Layers 2 and 3 share one instance of the sum (one copy of the code).
    const bool l3 = l == 3;
    layer_cells<KF, KF, CO, NTO, M, D, CYCLIC>(
        c0, nc, l3 ? a.taps3 : a.taps2, l3 ? a.cells3 : a.cells2, l3 ? act2 : act1, kf,
        l3 ? p.w3 : p.w2, l3 ? p.b3 : p.b2, kf, !l3, l3 ? act1f : nullptr, a.skip3, rank, nb,
        store(l3 ? act3 : act2, nullptr));
  }
}

// Layer 4 over cells [c0, c0 + nc): ReLU'd logits to emit(out_idx[j], ...).
template <int KF, int NL, int CO, int M, int D, bool CYCLIC, int P, class Emit>
__device__ __forceinline__ void logit_layer(const FwdArgs& a, const Params& p, int b,
                                            int c0, int nc, const int* out_idx, int rank,
                                            int nb, Emit emit) {
  const int kf = KF ? KF : a.kf;
  const auto* act3 =
      static_cast<const typename Operand<P>::T*>(a.act3) + (size_t)b * (a.G3 + 1) * kf;
  layer_cells<KF, NL, CO, NTO, M, D, CYCLIC>(c0, nc, a.taps4, out_idx, act3, kf, p.w4, p.b4,
                                             a.L, true, nullptr, nullptr, rank, nb, emit);
}

// ---------------------------------------------------------------------------
// Layer-parallel encode: one launch per layer, then the table launch
// ---------------------------------------------------------------------------

template <int KF, int NL, int M, bool WG, int P>
__global__ void __launch_bounds__(THREADS) encode_layer_kernel(FwdArgs a, int l) {
  extern __shared__ __align__(16) float sm[];
  const int kf = KF ? KF : a.kf, L = NL ? NL : a.L;
  const Params p = load_params<WG>(sm, a.params, kf, L);
  __syncthreads();
  const int b = blockIdx.y;
  if (l < 4) {
    hidden_layer<KF, (KF ? 4 : 1), M, 1, false, P>(a, p, l, b, 0,
                                          l == 1 ? a.N1 : (l == 2 ? a.N2 : a.N3),
                                          blockIdx.x, gridDim.x);
  } else {
    logit_layer<KF, NL, (KF ? 2 : 1), M, 1, false, P>(a, p, b, 0, a.N4, a.cells4, blockIdx.x,
                                             gridDim.x,
                                             StoreRow{a.logits + (size_t)b * a.n * L, L});
  }
}

// (B, T, CQ) entries: logits -> CDF -> the true symbol's (freq, start); 0 on
// dead lanes.
template <int NL>
__global__ void __launch_bounds__(THREADS) encode_tables_kernel(FwdArgs a) {
  const int L = NL ? NL : a.L;
  const size_t total = (size_t)a.B * a.T * a.CQ;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(e / ((size_t)a.T * a.CQ));
    const int idx = a.idx_cm[e % ((size_t)a.T * a.CQ)];
    int fs = 0, ss = 0;
    if (idx < a.n) {
      float lg[NL ? NL : MAX_L];
      const float* src = a.logits + ((size_t)b * a.n + idx) * L;
#pragma unroll
      for (int i = 0; i < (NL ? NL : MAX_L); ++i)
        if (i < L) lg[i] = src[i];
      int freq[NL ? NL : MAX_L], cdf[NL ? NL : MAX_L];
      cdf_from_logits<NL>(lg, L, freq, cdf);
      cdf_select<NL>(freq, cdf, L, a.true_syms[(size_t)b * a.n + idx], &fs, &ss);
    }
    a.fsel[e] = fs;
    a.ssel[e] = ss;
  }
}

// ---------------------------------------------------------------------------
// The scan: decode (mode 0) and the teacher-forced oracle (mode 1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// CO: output channels a thread owns in layers 1-3 (layer 4: at most 2); D:
// taps' rows in flight (cell_sum); P: the operand precision.
template <int KF, int NL, int CO, int D, bool WG, int P>
__global__ void __launch_bounds__(THREADS, 1) wavefront_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int win[RANS_WIN];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nb = (int)cluster.num_blocks();
  const int b = blockIdx.x / nb;
  const int kf = KF ? KF : a.kf, L = NL ? NL : a.L, n = a.n, T = a.T;
  constexpr int CO4 = CO > 2 ? 2 : CO;
  const Params p = load_params<WG>(sm, a.params, kf, L);
  // Behind the weights (if they are here): the step's logits (CQ x L floats;
  // rank 0's copy is the one every block writes), its (freq, cdf) tables (2 x
  // CQ x L), its idx_cm row (CQ) and the four layers' step pointers (4 x (T +
  // 1)).
  const int np4 = WG ? 0 : (params_size(kf, L) + 3) & ~3;
  float* lg_tab = sm + np4;
  int* f_tab = reinterpret_cast<int*>(lg_tab + a.CQ * L);
  int* c_tab = f_tab + a.CQ * L;
  int* idx_s = c_tab + a.CQ * L;
  int* sp = idx_s + a.CQ;
  const int* gp[4] = {a.ptr1, a.ptr2, a.ptr3, a.ptr4};
  for (int l = 0; l < 4; ++l)
    for (int i = threadIdx.x; i <= T; i += blockDim.x) sp[l * (T + 1) + i] = gp[l][i];
  float* lg_rank0 = cluster.map_shared_rank(lg_tab, 0);
  const int* taps_of[4] = {a.taps1, a.taps2, a.taps3, a.taps4};
  const int* out_of[4] = {a.cells1, a.cells2, a.cells3, a.slot4};

  QType<P>* qb = static_cast<QType<P>*>(a.qbuf) + (size_t)b * (n + 1);
  const int lane = threadIdx.x & 31;
  const bool rans_warp = a.mode == 0 && rank == 0 && threadIdx.x < 32;
  uint32_t st = 0, gptr = 0, base = 0;
  int cnt = 0, thr = 0;
  const int* stream = a.streams + (size_t)b * a.cap;
  if (rans_warp) {
    st = (uint32_t)a.init_states[b * R + lane];
    thr = a.thresh[b * R + lane];
    window_fill(win, stream, a.cap, base, 0, lane);
  }
  // Every block of the cluster runs before any writes into rank 0's memory.
  cluster.sync();

  // Optional profile: clocks of rank 0's thread 0 in each phase's work and
  // in each barrier (the wait for the slowest block included), summed over
  // the steps: layers 1-4 alternate work / barrier, then CDF + rANS, barrier.
  long long prof[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long tick = clock64();
  auto lap = [&](int i) {
    if (a.prof) {
      const long long now = clock64();
      prof[i] += now - tick;
      tick = now;
    }
  };
  // The barrier after layer l's phase of step t; between arriving and
  // waiting, the block fetches the index tables of the layer's next step.
  auto barrier = [&](int l, int t) {
    cluster_arrive();
    if (t + 1 < T) {
      const int* s = sp + (l - 1) * (T + 1);
      prefetch_cells(s[t + 1], s[t + 2] - s[t + 1], taps_of[l - 1], l == 1 ? NT1 : NTO,
                     out_of[l - 1], l == 3 ? a.skip3 : nullptr, rank, nb);
      if (l == 4 && rank == 0 && threadIdx.x * 32 < a.CQ)
        prefetch_l1(a.idx_cm + (size_t)(t + 1) * a.CQ + threadIdx.x * 32);
    }
    cluster_wait();
  };

  for (int t = 0; t < T; ++t) {
    for (int l = 1; l <= 3; ++l) {
      const int c0 = sp[(l - 1) * (T + 1) + t];
      hidden_layer<KF, CO, 1, D, true, P>(a, p, l, b, c0, sp[(l - 1) * (T + 1) + t + 1] - c0, rank,
                                 nb);
      lap(2 * l - 2);
      barrier(l, t);
      lap(2 * l - 1);
    }
    {
      const int c0 = sp[3 * (T + 1) + t];
      logit_layer<KF, NL, CO4, 1, D, true, P>(a, p, b, c0, sp[3 * (T + 1) + t + 1] - c0, a.slot4, rank,
                                     nb, StoreRow{lg_rank0, L});
    }
    lap(6);
    barrier(4, t);
    lap(7);

    if (rank == 0) {
      const int* idx_row = a.idx_cm + (size_t)t * a.CQ;
      const size_t out_row = ((size_t)b * T + t) * a.CQ;
      for (int cq = threadIdx.x; cq < a.CQ; cq += blockDim.x) {
        const int idx = idx_row[cq];
        idx_s[cq] = idx;
        int freq[NL ? NL : MAX_L], cdf[NL ? NL : MAX_L];
        if (idx < n) cdf_from_logits<NL>(lg_tab + cq * L, L, freq, cdf);
        if (a.mode == 1) {
          // Teacher-forced: the tables do not depend on rANS state.
          int fs = 0, ss = 0;
          if (idx < n) {
            const int sym = a.true_syms[(size_t)b * n + idx];
            cdf_select<NL>(freq, cdf, L, sym, &fs, &ss);
            qb[idx] = to_operand<P ? 1 : 0>(p.centers[sym]);
          }
          a.fsel[out_row + cq] = fs;
          a.ssel[out_row + cq] = ss;
        } else if (idx < n) {
#pragma unroll
          for (int l = 0; l < (NL ? NL : MAX_L); ++l)
            if (l < L) { f_tab[cq * L + l] = freq[l]; c_tab[cq * L + l] = cdf[l]; }
        }
      }
      if (a.mode == 0) {
        __syncthreads();
        if (rans_warp) {
          for (int si = 0; si < a.CQ / R; ++si) {
            const int cq = si * R + lane;
            const int idx = idx_s[cq];
            const bool act = idx < n;
            int sym = 0;
            uint32_t x = st;
            if (act) {
              const int* cd = c_tab + cq * L;
              const uint32_t slot = st & (SCALE - 1u);
              sym = -1;
              for (int l = 0; l < L; ++l) sym += ((uint32_t)cd[l] <= slot) ? 1 : 0;
              x = (uint32_t)f_tab[cq * L + sym] * (st >> 16) + slot - (uint32_t)cd[sym];
            }
            const bool need = act && x < RANS_L && cnt < thr;
            cnt += act ? 1 : 0;
            const unsigned mask = __ballot_sync(0xffffffffu, need);
            if (need) {
              // win[i] holds stream[min(base + i, cap - 1)]: the clamped read.
              const int off = (int)(gptr - base) + __popc(mask & ((1u << lane) - 1u));
              x = (x << 16) | ((uint32_t)win[off] & 0xFFFFu);
            }
            if (act) {
              st = x;
              a.syms_out[(size_t)b * n + idx] = sym;
              qb[idx] = to_operand<P ? 1 : 0>(p.centers[sym]);
            }
            gptr += (uint32_t)__popc(mask);
            window_slide(win, stream, a.cap, gptr, base, lane);
          }
        }
      }
    }
    lap(8);
    cluster.sync();
    lap(9);
  }
  if (a.prof && rank == 0 && threadIdx.x == 0)
    for (int i = 0; i < 10; ++i) a.prof[b * 10 + i] = prof[i];
}

// Dynamic shared memory of the scan: the weights (unless they stay in device
// memory), the step's logits, (freq, cdf) tables and idx_cm row, and the
// layers' step pointers.
static size_t scan_smem(int kf, int L, int CQ, int T, bool wdev) {
  const size_t np4 = wdev ? 0 : (params_size(kf, L) + 3) & ~3;
  return (np4 + 3 * (size_t)CQ * L + CQ + 4 * ((size_t)T + 1)) * sizeof(float);
}

static bool valid(const FwdArgs& a) {
  return a.L >= 2 && a.L <= MAX_L && a.kf >= 1 && a.CQ % R == 0 && a.B >= 1 &&
         a.prec >= 0 && a.prec <= 2;
}

// Whether `kernel` runs with `smem` bytes of dynamic shared memory on the
// current device: its static shared memory plus smem within the opt-in limit.
static cudaError_t fits(const void* kernel, size_t smem, bool* ok) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess) *ok = fa.sharedSizeBytes + smem <= (size_t)optin;
  return err;
}

static void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks,
                           int cluster, size_t smem, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

typedef void (*ScanKernel)(FwdArgs);

struct ScanChoice {
  ScanKernel kernel;
  size_t smem;
  bool wdev;
};

// The scan's instance for these widths, this precision and where its
// weights live: compile-time widths with 4 channels a thread and 2 taps'
// rows in flight (kf = 24 or 64 at L = 6), or the generic one; the weights
// in shared memory if they fit (never at kf = 64, L = 6), else in device
// memory.
template <int P>
static cudaError_t choose_scan_p(int kf, int L, int CQ, int T, int force, ScanChoice* c) {
  const bool generic = (force & FORCE_GENERIC) || L != 6 || (kf != 24 && kf != 64);
  const ScanKernel in_smem = generic ? wavefront_kernel<0, 0, 1, 1, false, P>
                             : kf == 24 ? wavefront_kernel<24, 6, 4, 2, false, P> : nullptr;
  const ScanKernel in_dev = generic ? wavefront_kernel<0, 0, 1, 1, true, P>
                            : kf == 24 ? wavefront_kernel<24, 6, 4, 2, true, P>
                                       : wavefront_kernel<64, 6, 4, 2, true, P>;
  bool ok = false;
  if (in_smem && !(force & FORCE_WDEV)) {
    const cudaError_t err = fits((const void*)in_smem, scan_smem(kf, L, CQ, T, false), &ok);
    if (err != cudaSuccess) return err;
  }
  c->wdev = !ok;
  c->kernel = ok ? in_smem : in_dev;
  c->smem = scan_smem(kf, L, CQ, T, c->wdev);
  return cudaSuccess;
}

static cudaError_t choose_scan(int kf, int L, int CQ, int T, int force, int prec,
                               ScanChoice* c) {
  if (prec == 1) return choose_scan_p<1>(kf, L, CQ, T, force, c);
  if (prec == 2) return choose_scan_p<2>(kf, L, CQ, T, force, c);
  return choose_scan_p<0>(kf, L, CQ, T, force, c);
}

// The scan (mode 0 decode, mode 1 encode oracle) over clusters of a.cluster
// blocks an image.
extern "C" int wavefront_forward(FwdArgs a, cudaStream_t stream) {
  if (!valid(a) || a.cluster < 1 || a.cluster > 8) return (int)cudaErrorInvalidValue;
  ScanChoice c;
  cudaError_t err = choose_scan(a.kf, a.L, a.CQ, a.T, a.force, a.prec, &c);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, a.B * a.cluster, a.cluster, c.smem, stream);
  err = cudaLaunchKernelEx(&cfg, c.kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks of the scan (its instance of
// precision `prec`) the card holds at once (cudaOccupancyMaxActiveClusters),
// or a negative cudaError.
extern "C" int wavefront_max_clusters(int kf, int L, int CQ, int T, int cluster, int prec) {
  if (prec < 0 || prec > 2) return -(int)cudaErrorInvalidValue;
  ScanChoice c;
  cudaError_t err = choose_scan(kf, L, CQ, T, 0, prec, &c);
  if (err != cudaSuccess) return -(int)err;
  err = cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)c.smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, cluster, cluster, c.smem, nullptr);
  int num = 0;
  err = cudaOccupancyMaxActiveClusters(&num, c.kernel, &cfg);
  return err == cudaSuccess ? num : -(int)err;
}

template <int KF, int NL, int M, bool WG, int P>
static int launch_encode(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = WG ? 0 : (size_t)params_size(a.kf, a.L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      encode_layer_kernel<KF, NL, M, WG, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int counts[4] = {a.N1, a.N2, a.N3, a.N4};
  const int per_image = 1056 / a.B > 1 ? 1056 / a.B : 1;   // ~8 blocks an SM in all
  for (int l = 1; l <= 4; ++l) {
    const int groups = KF ? (l == 4 ? NL / 2 : KF / 4) : (l == 4 ? a.L : a.kf);
    const long items = (long)((counts[l - 1] + M - 1) / M) * groups;
    long blocks = (items + THREADS - 1) / THREADS;
    blocks = blocks < 1 ? 1 : (blocks > per_image ? per_image : blocks);
    encode_layer_kernel<KF, NL, M, WG, P>
        <<<dim3((unsigned)blocks, a.B), THREADS, smem, stream>>>(a, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t total = (size_t)a.B * a.T * a.CQ;
  size_t blocks = (total + THREADS - 1) / THREADS;
  blocks = blocks > 132 * 16 ? 132 * 16 : blocks;
  encode_tables_kernel<NL><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Where the layer-parallel encode keeps its weights: shared memory if they
// fit and nothing asks otherwise (never at kf = 64, L = 6).
template <int P>
static cudaError_t encode_wdev(const FwdArgs& a, bool* wdev) {
  const bool fixed = a.L == 6 && (a.kf == 24 || a.kf == 64) && !(a.force & FORCE_GENERIC);
  *wdev = true;
  if ((a.force & FORCE_WDEV) || (fixed && a.kf == 64)) return cudaSuccess;
  bool ok = false;
  const cudaError_t err = fits(fixed ? (const void*)encode_layer_kernel<24, 6, 2, false, P>
                                     : (const void*)encode_layer_kernel<0, 0, 1, false, P>,
                               (size_t)params_size(a.kf, a.L) * sizeof(float), &ok);
  *wdev = !ok;
  return err;
}

template <int P>
static int encode_p(const FwdArgs& a, cudaStream_t stream) {
  bool wdev;
  const cudaError_t err = encode_wdev<P>(a, &wdev);
  if (err != cudaSuccess) return (int)err;
  // Compile-time widths: a thread owns 2 cells x 4 channels (layer 4: x 2).
  if (a.L == 6 && !(a.force & FORCE_GENERIC)) {
    if (a.kf == 24)
      return wdev ? launch_encode<24, 6, 2, true, P>(a, stream)
                  : launch_encode<24, 6, 2, false, P>(a, stream);
    if (a.kf == 64) return launch_encode<64, 6, 2, true, P>(a, stream);
  }
  return wdev ? launch_encode<0, 0, 1, true, P>(a, stream)
              : launch_encode<0, 0, 1, false, P>(a, stream);
}

// The layer-parallel teacher-forced encode: 4 layer launches and the table
// launch on `stream`.
extern "C" int wavefront_encode(FwdArgs a, cudaStream_t stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (a.prec == 1) return encode_p<1>(a, stream);
  if (a.prec == 2) return encode_p<2>(a, stream);
  return encode_p<0>(a, stream);
}

// Where the weights of the scan (encode = 0) or of the layer-parallel encode
// (encode = 1) live for these widths: 1 in device memory, 0 in shared
// memory, or a negative cudaError.
extern "C" int wavefront_weights_in_device(int kf, int L, int CQ, int T, int force,
                                           int encode, int prec) {
  if (prec < 0 || prec > 2) return -(int)cudaErrorInvalidValue;
  bool wdev = false;
  cudaError_t err;
  if (encode) {
    FwdArgs a{};
    a.kf = kf;
    a.L = L;
    a.force = force;
    err = prec == 1 ? encode_wdev<1>(a, &wdev)
                    : prec == 2 ? encode_wdev<2>(a, &wdev) : encode_wdev<0>(a, &wdev);
  } else {
    ScanChoice c;
    err = choose_scan(kf, L, CQ, T, force, prec, &c);
    wdev = c.wdev;
  }
  return err == cudaSuccess ? (int)wdev : -(int)err;
}
