// The planar (K != 3) wavefront forward, encode and decode (kernel 5 of the
// port).
//
// Replaces the TPU kernel imgcomp_cvpr_tpu/coding/planar_kernel.py::
// make_plane_forward (pl.pallas_call at :393): its enc_teacher variant (the
// teacher-forced per-lane (freq, start) tables), its dec_only variant (the
// sequential 32-lane interleaved rANS decode with the per-plane tail-packing
// threshold) and its shared mode-flag variant. Every layer sum is cell_sum
// of layer_sum.cuh and every CDF is cdf_from_logits of cdf.cuh (both shared
// with kernel 2); encode and decode compute their logits and CDFs with these
// same two functions, which is what makes the streams decode bit-exactly.
//
// Geometry (coding/planar.py). Cell (h, w) of level l of a plane is computed
// at step t = BH*h + w + CTR*l from the top-slice taps of level l-1 of the
// same plane plus its bias row (the lower kernel slices over the known planes
// below, convolutions the caller runs); level 0 is the padded q plane, level
// 4 the logits. Activations are whole (H_l, W_l, kf) grids in device memory.
//
// Three entries.
//
// plane_level + plane_tables: the teacher-forced encode as layer-parallel
// passes over the whole card. All symbols are known, so level l of every
// plane depends only on level l-1 (and, through the bias rows, on level l-1
// of the planes below): one plane_level launch covers all cells of level l
// of all B x C (image, plane) pairs, a thread owning 2 cells x CO output
// channels; plane_tables turns the logits into the (plane, step, lane)
// (freq, start) tables. Five launches a batch, where the scan took one a
// plane.
//
// plane_forward: the scan over one plane's T2 steps, one block per image.
// Mode 0 is the decoder (q -> level 1 -> 2 -> 3 -> 4 -> symbol -> q is a
// true recurrence); mode 1 is the teacher-forced scan kept as the encode's
// consistency oracle (the counterpart of the TPU kernel's shared mode-flag
// variant). A step has at most ~13 cells a level, 312 (cell, channel) work
// items: that does not feed a cluster, and what a step costs is latency. So
// the block has just the threads of one band (a.threads, from the wrapper),
// a thread owns one (cell, channel) and starts a whole tap's 24 loads and
// multiplies before its 24 dependent adds (widths at compile time, x as
// float4; 2 or 4 channels a thread were measured and were slower: fewer
// warps, longer serial chains), the CDF is computed with L at compile time in
// registers, and the stream words come through a shared-memory window
// (rans_window.cuh). Per step: level 1 | barrier | 2 | barrier | 3 (+ skip) |
// barrier | 4 -> logits in shared memory | barrier | warp 0: CDF, slot
// search, state update, renorm pulls ranked with __ballot_sync/__popc, `cnt <
// thr` suppression, exactly like rans.decode_step_interleaved; q write |
// barrier. Each barrier stands on the recurrence (the centre tap of levels
// 2-4 and level 3's skip read cells written earlier in the same step).
//
// Where a step's operands come from. The ring path (RING; K = 5, kf = 24)
// reads nothing from device memory inside the recurrence. A tap of a level-l
// cell reads level l-1 on one of its last CTR + 1 = 21 diagonals (level 3's
// skip and the centre taps: on the current one), so each of levels 0 (the
// padded q plane), 1, 2 and 3 keeps its last 21 diagonals in a ring in
// shared memory, cell (h, diagonal v) in slot (v % 21) * rslot + h % rslot
// (rslot >= the most cells a diagonal has; coding/planar_kernel.py::
// ring_geometry). A phase computes from the rings, writes its cells to its
// ring, and stores them to the level's grid in device memory too (PlaneOut
// returns them and the next plane's bias rows read them; nothing in the step
// waits for those stores); warp 0 writes each symbol's centre into the q
// ring; the step's first phase puts the pad value back into the q ring's row
// of the step's diagonal (the row of the diagonal 21 back, which no phase of
// this step reads). Each thread loads the bias-row values of its (cell,
// channel) of all four levels a step ahead, into registers, in the level-4
// phase, where most warps have no cell. Kodak latent (64 x 96): rslot 13, 80
// KB of rings beside the 68.6 KB of weights. Where the
// rings do not fit under the opt-in limit, or a band has more (cell, channel)
// items than the block has threads (a wide latent: ~29 cells a diagonal at
// 1080p), the wrapper passes rslot = 0 and the staged path runs: the block
// fetches the tap rows of a phase's cells from the grids in device memory
// into shared memory in one sweep (stage_rows of layer_sum.cuh: one memory
// latency a phase, not one a tap; one block per image, so plain loads are
// coherent), and reads each bias row where it is used. Both paths call
// cell_sum with the same widths (the ring path keeps four of level 1's
// one-float tap rows in flight, the staged path one): every sum keeps its
// (tap, channel) order, and the bits are the same.
//
// Template instances: <KF = 24, NL = 6, N1 = 12, NO = 13> (K = 5 with the
// shipped widths: the `pc base` context model; the scan's ring path is one
// more instance of it) and <0, 0, 0, 0>, the generic instance for any other K
// or width (one (cell, channel) a thread, run-time loops, two loads per
// multiply: the first version's inner loop, several times slower).
//
// Where the weights live (WG), as in kernel 2: in a block's dynamic shared
// memory while they (and the scan's staged tap rows) fit within the card's
// opt-in limit (cudaDevAttrMaxSharedMemoryPerBlockOptin; up to kf ~45 at K =
// 5, L = 6), else all of them in device memory, read through L1 / L2 (kf =
// 64: 439 KB). Only where an operand comes from changes, not the order of any
// sum. PlaneArgs::force asks for the device-memory placement or the generic
// instance where they are not needed (tests and chip_smoke.py); either also
// keeps the scan off the ring path, which holds the weights in shared memory.
//
// Bound on the H100: operations; the top-slice taps of one Kodak-size plane
// (64 x 96, K=5, kf=24) are ~0.45 GFLOP per image in f32 (chip_smoke.py
// counts them and prints the measured times). The decode's second figure is
// its chain floor: 12 + 3 * 13 * 24 = 948 dependent adds a step.

#include <cuda_runtime.h>
#include <stdint.h>

#define R 32
#define MAX_L 16
#define MAX_TAPS 32
#define SCALE 65536u
#define RANS_L 65536u
#define ENC_THREADS 256
#define SCAN_MAX_THREADS 512
#define FORCE_WDEV 1      // weights in device memory even where they fit
#define FORCE_GENERIC 2   // the generic instance even where a fixed one exists

#include "cdf.cuh"
#include "layer_sum.cuh"
#include "rans_window.cuh"

struct PlaneArgs {
  int mode, B, H, W, K, BH, CTR, T2, kf, L, cap, threads, level;
  int force;         // FORCE_WDEV | FORCE_GENERIC, or 0: the host's own choice
  int rslot;         // scan: ring slots a diagonal (the ring path), or 0 (staged)
  int nt[4];
  int tdy[4][MAX_TAPS];
  int tdx[4][MAX_TAPS];
  const float* params;
  const float *bias1, *bias2, *bias3, *bias4;
  float *act1, *act2, *act3, *qplane;
  float* logits;
  const int* idx_cm;
  const int* true_plane;
  int *fsel, *ssel;
  const int* streams;
  const int* states_in;
  const int* gptr_in;
  const int* thresh;
  int *syms_out, *states_out, *gptr_out;
  long long* prof;   // optional (B, 5) clock sums of thread 0 (scan), or null
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

__host__ __device__ inline int params_size(const int* nt, int kf, int L) {
  return nt[0] * kf + (nt[1] + nt[2]) * kf * kf + nt[3] * kf * L + 1 + L;
}

// One level of one (image, plane): grids, weights, bias row, skip.
struct Level {
  int Hl, Wl, Ws, cin, cout, nt, sk, Wsk;
  const int *tdy, *tdx;
  const float *src, *w, *bias, *skip;
  float* dst;
  bool relu;
};

// Address of tap k's input row of cell (h, wc) in the level below.
template <int CIN>
__device__ __forceinline__ const float* tap_row(const Level& lv, int h, int wc, int k) {
  const int cin = CIN > 0 ? CIN : lv.cin;
  return lv.src + ((size_t)(h + lv.tdy[k]) * lv.Ws + (wc + lv.tdx[k])) * cin;
}

// Output channels [ch, ch + CO) of the M cells (h[m], wc[m]): the sum over
// the level's top-slice taps (cell_sum, or its generic instance when CIN ==
// 0, M == CO == 1), then the bias row, level 3's skip, ReLU. row(m, k): where
// tap k's input row of cell m is read from (the level below, or the rows
// stage_rows put in shared memory).
template <int CIN, int COUT, int CO, int NT, int M, class Row>
__device__ __forceinline__ void level_cells(const Level& lv, const int (&h)[M],
                                            const int (&wc)[M], int ch,
                                            float (&acc)[M][CO], Row row) {
  if constexpr (CIN > 0) {
    cell_sum<CIN, COUT, CO, NT, M, 1, false>(acc, row, lv.w, ch);
  } else {
    acc[0][0] = cell_sum_any<false>([&](int k) { return row(0, k); }, lv.w, ch, lv.cin,
                                    lv.cout, lv.nt);
  }
  const int cout = COUT > 0 ? COUT : lv.cout;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int i = 0; i < CO; ++i) {
      float v = __fadd_rn(acc[m][i], lv.bias[((size_t)h[m] * lv.Wl + wc[m]) * cout + ch + i]);
      if (lv.skip)
        v = __fadd_rn(v, lv.skip[((size_t)(h[m] + lv.sk) * lv.Wsk + (wc[m] + lv.sk)) * cout
                                 + ch + i]);
      acc[m][i] = lv.relu && v < 0.f ? 0.f : v;  // NaN stays NaN (jax.nn.relu)
    }
  }
}

struct Weights {
  const float *w1, *w2, *w3, *w4, *pad, *centers;
};

// Slice the packed weights: copied into shared memory, or (WG) read where
// they are, in device memory.
template <bool WG>
__device__ __forceinline__ Weights load_weights(float* sm, const PlaneArgs& a) {
  const float* base = a.params;
  if constexpr (!WG) {
    const int np = params_size(a.nt, a.kf, a.L);
    for (int i = threadIdx.x; i < np; i += blockDim.x) sm[i] = a.params[i];
    base = sm;
  }
  Weights p;
  p.w1 = base;
  p.w2 = p.w1 + a.nt[0] * a.kf;
  p.w3 = p.w2 + a.nt[1] * a.kf * a.kf;
  p.w4 = p.w3 + a.nt[2] * a.kf * a.kf;
  p.pad = p.w4 + a.nt[3] * a.kf * a.L;
  p.centers = p.pad + 1;
  return p;
}

// Level l = 1..4 of (image, plane) `bp` of the arrays in `a`.
__device__ __forceinline__ Level make_level(const PlaneArgs& a, const Weights& p, int l,
                                            int bp) {
  const int half = a.K / 2, kf = a.kf;
  auto Hof = [&](int lv) { return a.H + 2 * (4 - lv) * half; };
  auto Wof = [&](int lv) { return a.W + 2 * (4 - lv) * half; };
  const float* srcs[4] = {a.qplane, a.act1, a.act2, a.act3};
  float* dsts[4] = {a.act1, a.act2, a.act3, a.logits};
  const float* biases[4] = {a.bias1, a.bias2, a.bias3, a.bias4};
  const float* ws[4] = {p.w1, p.w2, p.w3, p.w4};
  Level lv;
  lv.Hl = Hof(l);
  lv.Wl = Wof(l);
  lv.Ws = Wof(l - 1);
  lv.cin = l == 1 ? 1 : kf;
  lv.cout = l == 4 ? a.L : kf;
  lv.nt = a.nt[l - 1];
  lv.tdy = a.tdy[l - 1];
  lv.tdx = a.tdx[l - 1];
  lv.src = srcs[l - 1] + (size_t)bp * Hof(l - 1) * Wof(l - 1) * lv.cin;
  lv.w = ws[l - 1];
  lv.bias = biases[l - 1] + (size_t)bp * lv.Hl * lv.Wl * lv.cout;
  lv.dst = dsts[l - 1] ? dsts[l - 1] + (size_t)bp * lv.Hl * lv.Wl * lv.cout : nullptr;
  lv.relu = l != 3;
  lv.skip = l == 3 ? a.act1 + (size_t)bp * Hof(1) * Wof(1) * kf : nullptr;
  lv.sk = a.K - 1;
  lv.Wsk = Wof(1);
  return lv;
}

template <int CO>
__device__ __forceinline__ void store_cell(float* p, const float (&v)[CO]) {
  if constexpr (CO == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (CO == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < CO; ++i) p[i] = v[i];
  }
}

// ---------------------------------------------------------------------------
// Layer-parallel encode: one launch per level over all (image, plane) pairs
// ---------------------------------------------------------------------------

// Every cell of the level: a thread owns CO channels of M consecutive cells
// (each weight it loads serves M cells).
template <int CIN, int COUT, int CO, int NT, int M>
__device__ __forceinline__ void level_all_cells(const Level& lv) {
  const int groups = CIN > 0 ? COUT / CO : lv.cout;
  const int ncell = lv.Hl * lv.Wl, units = (ncell + M - 1) / M;
  for (int it = blockIdx.x * blockDim.x + threadIdx.x; it < units * groups;
       it += gridDim.x * blockDim.x) {
    const int u = it / groups, ch = (it % groups) * CO;
    int h[M], wc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      // A unit's missing cells (the grid's ragged end) repeat its first.
      const int cell = u * M + m < ncell ? u * M + m : u * M;
      h[m] = cell / lv.Wl;
      wc[m] = cell % lv.Wl;
    }
    float acc[M][CO];
    level_cells<CIN, COUT, CO, NT, M>(
        lv, h, wc, ch, acc, [&](int m, int k) { return tap_row<CIN>(lv, h[m], wc[m], k); });
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (u * M + m < ncell)
        store_cell<CO>(lv.dst + ((size_t)h[m] * lv.Wl + wc[m]) * lv.cout + ch, acc[m]);
  }
}

template <int KF, int NL, int N1, int NO, bool WG>
__global__ void __launch_bounds__(ENC_THREADS) plane_level_kernel(PlaneArgs a) {
  extern __shared__ __align__(16) float sm[];
  const Weights p = load_weights<WG>(sm, a);
  __syncthreads();
  const Level lv = make_level(a, p, a.level, blockIdx.y);
  if constexpr (KF > 0) {
    if (a.level == 1) level_all_cells<1, KF, 4, N1, 2>(lv);
    else if (a.level == 4) level_all_cells<KF, NL, 2, NO, 2>(lv);
    else level_all_cells<KF, KF, 4, NO, 2>(lv);
  } else {
    level_all_cells<0, 0, 1, 0, 1>(lv);
  }
}

// (B*C, T2, R) lanes: logits -> CDF -> the true symbol's (freq, start); 0 on
// dead lanes.
template <int NL>
__global__ void __launch_bounds__(ENC_THREADS) plane_tables_kernel(PlaneArgs a) {
  const int L = NL ? NL : a.L, HW = a.H * a.W;
  const size_t per = (size_t)a.T2 * R, total = (size_t)a.B * per;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t bp = e / per;
    const int idx = a.idx_cm[e % per];
    int fs = 0, ss = 0;
    if (idx < HW) {
      float lg[NL ? NL : MAX_L];
      const float* src = a.logits + (bp * HW + idx) * L;
#pragma unroll
      for (int i = 0; i < (NL ? NL : MAX_L); ++i)
        if (i < L) lg[i] = src[i];
      int freq[NL ? NL : MAX_L], cdf[NL ? NL : MAX_L];
      cdf_from_logits<NL>(lg, L, freq, cdf);
      cdf_select<NL>(freq, cdf, L, a.true_plane[bp * HW + idx], &fs, &ss);
    }
    a.fsel[e] = fs;
    a.ssel[e] = ss;
  }
}

// ---------------------------------------------------------------------------
// The scan over one plane: decode (mode 0) and the encode oracle (mode 1)
// ---------------------------------------------------------------------------

// The cells of diagonal v of one level: every (cell, channel group) is one
// work item of the block. With compile-time widths the block first stages
// the tap rows of up to STAGE_CELLS cells in `xs` (stage_rows: one memory
// latency a phase, not one a tap). band != nullptr stores to
// band[(h - h_lo) * cout + ch] (the shared-memory logits), else into the
// level's grid.
#define STAGE_CELLS 32

template <int CIN, int COUT, int CO, int NT>
__device__ __forceinline__ void level_band(const Level& lv, int v, int BH, float* band,
                                           float* xs) {
  if (v < 0) return;
  const int h_lo = band_lo(v, lv.Wl, BH);
  const int nc = band_hi(v, lv.Hl, BH) - h_lo + 1;
  const int groups = CIN > 0 ? COUT / CO : lv.cout;
  auto store = [&](int r, int ch, const float (&acc)[CO]) {
    const int h = h_lo + r, wc = v - BH * h;
    float* o = band ? band + r * lv.cout + ch
                    : lv.dst + ((size_t)h * lv.Wl + wc) * lv.cout + ch;
#pragma unroll
    for (int i = 0; i < CO; ++i) o[i] = acc[i];
  };
  if constexpr (CIN > 0) {
    constexpr int S = stage_stride<CIN, NT>();
    for (int r0 = 0; r0 < nc; r0 += STAGE_CELLS) {        // block-uniform
      const int ncell = nc - r0 < STAGE_CELLS ? nc - r0 : STAGE_CELLS;
      if (r0 > 0) __syncthreads();
      stage_rows<CIN, NT, false>(xs, ncell, [&](int cell, int k) {
        const int h = h_lo + r0 + cell;
        return tap_row<CIN>(lv, h, v - BH * h, k);
      });
      __syncthreads();
      for (int it = threadIdx.x; it < ncell * groups; it += blockDim.x) {
        const int cell = it / groups, ch = (it % groups) * CO;
        const int h[1] = {h_lo + r0 + cell}, wc[1] = {v - BH * h[0]};
        float acc[1][CO];
        level_cells<CIN, COUT, CO, NT, 1>(
            lv, h, wc, ch, acc, [&](int, int k) { return xs + cell * S + k * CIN; });
        store(r0 + cell, ch, acc[0]);
      }
    }
  } else {
    for (int it = threadIdx.x; it < nc * groups; it += blockDim.x) {
      const int r = it / groups, ch = (it % groups) * CO;
      const int h[1] = {h_lo + r}, wc[1] = {v - BH * h[0]};
      float acc[1][CO];
      level_cells<CIN, COUT, CO, NT, 1>(
          lv, h, wc, ch, acc, [&](int, int k) { return tap_row<CIN>(lv, h[0], wc[0], k); });
      store(r, ch, acc[0]);
    }
  }
}

// The ring path's geometry, at compile time: K = 5 (BH = 9, CTR = 20); a
// ring keeps RING_D = CTR + 1 diagonals. Tap k of a K = 5 mask is (dy, dx) =
// (k / 5, k % 5) (the host checks), on diagonal v + BH dy + dx of the level
// below; level 3's skip is level-1 cell (h + 4, w + 4), on diagonal v + 40.
#define RING_K 5
#define RING_BH 9
#define RING_CTR 20
#define RING_D (RING_CTR + 1)

// The rings' floats: level 0 (one float a cell, padded to a float4), levels 1-3.
static int ring_floats(int rslot, int kf) {
  return (RING_D * rslot + 3) / 4 * 4 + 3 * RING_D * rslot * kf;
}

// Cell (h, diagonal v)'s slot in a ring of rslot cells a diagonal.
__device__ __forceinline__ int ring_slot(int v, int h, int ns) {
  return (v % RING_D) * ns + h % ns;
}

// One thread's cell of each level at one step (h < 0: the step's diagonal of
// that level has no cell for it) and the cell's bias-row value.
struct RingWork {
  int h[4];
  float bias[4];
};

// A thread's cells of step t, with their bias-row values: it owns (cell,
// channel) (tid / KF, tid % KF) of a band in levels 1-3 and (tid / NL, tid %
// NL) in level 4. Called a step ahead, so the loads are in flight while the
// step before runs; a thread with no cell loads the grid's first value,
// unused, so that no branch stands around the loads.
template <int KF, int NL>
__device__ __forceinline__ RingWork ring_work(const Level (&lv)[4], int t) {
  RingWork r;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int co = l < 3 ? KF : NL;
    const int v = t - (l + 1) * RING_CTR;
    const int h = band_lo(v, lv[l].Wl, RING_BH) + (int)threadIdx.x / co;
    const bool on = v >= 0 && h <= band_hi(v, lv[l].Hl, RING_BH);
    r.h[l] = on ? h : -1;
    const int i = on ? (h * lv[l].Wl + v - RING_BH * h) * co + (int)threadIdx.x % co : 0;
    r.bias[l] = __ldg(lv[l].bias + i);
  }
  return r;
}

// The top-slice sum of channel ch of the level cell (h, diagonal v), its tap
// rows read from `src`, the ring of the level below (CIN floats a cell, ns
// slots a diagonal): cell_sum as the staged path calls it, with DD taps' rows
// in flight (it sets when a row is read, not the order of the sum).
template <int CIN, int COUT, int NT, int DD = 1>
__device__ __forceinline__ float ring_sum(const float* w, int ch, const float* src, int ns,
                                          int v, int h) {
  const int rv = v % RING_D, hc = h % ns;
  float acc[1][1];
  cell_sum<CIN, COUT, 1, NT, 1, DD, false>(
      acc,
      [&](int, int k) {
        const int dy = k / RING_K, dx = k - RING_K * dy;
        int r = rv + RING_BH * dy + dx;
        r = r >= RING_D ? r - RING_D : r;
        int c = hc + dy;                    // dy <= 2 < ns
        c = c >= ns ? c - ns : c;
        return src + (r * ns + c) * CIN;
      },
      w, ch);
  return acc[0][0];
}

// RING (KF > 0, !WG): the ring path, a.rslot slots a diagonal.
template <int KF, int NL, int N1, int NO, bool WG, bool RING>
__global__ void __launch_bounds__(SCAN_MAX_THREADS) plane_kernel(PlaneArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float lg[R * MAX_L];
  __shared__ int win[RANS_WIN];
  const int b = blockIdx.x, L = NL ? NL : a.L, BH = a.BH;
  const int reach = 4 * (a.K / 2), W0 = a.W + 2 * reach, H0 = a.H + 2 * reach;
  const Weights p = load_weights<WG>(sm, a);
  // Behind the weights: the staged tap rows, or the ring path's rings.
  float* xs = sm + (WG ? 0 : (params_size(a.nt, a.kf, a.L) + 3) & ~3);
  const int HW = a.H * a.W;
  float* q = a.qplane + (size_t)b * H0 * W0;
  const float pad = a.params[params_size(a.nt, a.kf, a.L) - 1 - a.L];
  for (int i = threadIdx.x; i < H0 * W0; i += blockDim.x) q[i] = pad;
  __syncthreads();
  const Level lv1 = make_level(a, p, 1, b), lv2 = make_level(a, p, 2, b);
  const Level lv3 = make_level(a, p, 3, b), lv4 = make_level(a, p, 4, b);
  const int ns = a.rslot;    // the rings of levels 0-3
  float* const ring0 = xs;
  float* const ring1 = ring0 + (RING_D * ns + 3) / 4 * 4;
  float* const ring2 = ring1 + RING_D * ns * KF;
  float* const ring3 = ring2 + RING_D * ns * KF;

  const int lane = threadIdx.x & 31;
  const bool rans_warp = (a.mode == 0) && threadIdx.x < 32;
  uint32_t st = 0, gptr = 0, base = 0;
  int cnt = 0, thr = 0;
  const int* stream = a.streams + (size_t)b * a.cap;
  if (rans_warp) {
    st = (uint32_t)a.states_in[b * R + lane];
    gptr = base = (uint32_t)a.gptr_in[b];
    thr = a.thresh[b * R + lane];
    window_fill(win, stream, a.cap, base, 0, lane);
  }
  __syncthreads();

  // Optional profile: thread 0's clocks in levels 1-4 (each with its
  // barrier) and in the CDF + rANS part, summed over the steps.
  long long prof[5] = {0, 0, 0, 0, 0};
  long long tick = clock64();
  auto lap = [&](int i) {
    if (a.prof) {
      const long long now = clock64();
      prof[i] += now - tick;
      tick = now;
    }
  };

  // The ring path fetches a step's cells and bias-row values a step ahead.
  const Level lvs[4] = {lv1, lv2, lv3, lv4};
  RingWork cur{}, nxt{};
  if constexpr (RING) cur = ring_work<KF, NL>(lvs, 0);

  for (int t = 0; t < a.T2; ++t) {
    const int v4 = t - 4 * a.CTR;
    if constexpr (RING) {
      const int ch = threadIdx.x % KF, ch4 = threadIdx.x % NL, cell4 = threadIdx.x / NL;
      // The q ring's row of this step's diagonal back to pad (its diagonal
      // 21 back is dead: level 1 reads diagonals t - 20 .. t - 1).
      for (int i = threadIdx.x; i < ns; i += blockDim.x) ring0[(t % RING_D) * ns + i] = pad;
      if (cur.h[0] >= 0) {
        const int v = t - RING_CTR, h = cur.h[0];
        // Level 1's taps are one float each: four taps' rows in flight.
        float y = __fadd_rn(ring_sum<1, KF, N1, 4>(p.w1, ch, ring0, ns, v, h), cur.bias[0]);
        y = y < 0.f ? 0.f : y;
        ring1[ring_slot(v, h, ns) * KF + ch] = y;
        lv1.dst[((size_t)h * lv1.Wl + (v - RING_BH * h)) * KF + ch] = y;
      }
      __syncthreads();
      lap(0);
      for (int l = 2; l <= 3; ++l) {
        const int h = l == 2 ? cur.h[1] : cur.h[2];
        if (h >= 0) {
          const int v = t - l * RING_CTR;
          float y = ring_sum<KF, KF, NO>(l == 2 ? p.w2 : p.w3, ch, l == 2 ? ring1 : ring2, ns,
                                         v, h);
          y = __fadd_rn(y, l == 2 ? cur.bias[1] : cur.bias[2]);
          if (l == 3)
            y = __fadd_rn(y, ring1[ring_slot(v + 2 * RING_CTR, h + RING_K - 1, ns) * KF + ch]);
          else
            y = y < 0.f ? 0.f : y;
          (l == 2 ? ring2 : ring3)[ring_slot(v, h, ns) * KF + ch] = y;
          const Level& lv = l == 2 ? lv2 : lv3;
          lv.dst[((size_t)h * lv.Wl + (v - RING_BH * h)) * KF + ch] = y;
        }
        __syncthreads();
        lap(l - 1);
      }
      // The next step's cells and bias-row values: most warps have no
      // level-4 cell, and the loads have the decode phase to land.
      nxt = ring_work<KF, NL>(lvs, t + 1);
      if (cur.h[3] >= 0) {
        const float y = __fadd_rn(ring_sum<KF, NL, NO>(p.w4, ch4, ring3, ns, v4, cur.h[3]),
                                  cur.bias[3]);
        lg[cell4 * NL + ch4] = y < 0.f ? 0.f : y;
      }
    } else if constexpr (KF > 0) {
      level_band<1, KF, 1, N1>(lv1, t - a.CTR, BH, nullptr, xs);
      __syncthreads();
      lap(0);
      // Levels 2 and 3 share one instance of the sum (one copy of the code).
      for (int l = 2; l <= 3; ++l) {
        level_band<KF, KF, 1, NO>(l == 2 ? lv2 : lv3, t - l * a.CTR, BH, nullptr, xs);
        __syncthreads();
        lap(l - 1);
      }
      level_band<KF, NL, 1, NO>(lv4, v4, BH, lg, xs);
    } else {
      level_band<0, 0, 1, 0>(lv1, t - a.CTR, BH, nullptr, nullptr);
      __syncthreads();
      level_band<0, 0, 1, 0>(lv2, t - 2 * a.CTR, BH, nullptr, nullptr);
      __syncthreads();
      level_band<0, 0, 1, 0>(lv3, t - 3 * a.CTR, BH, nullptr, nullptr);
      __syncthreads();
      level_band<0, 0, 1, 0>(lv4, v4, BH, lg, nullptr);
    }
    __syncthreads();
    lap(3);

    // The step's band: lane r = level-4 cell h_lo + r.
    int h_lo = 0, nband = 0;
    if (v4 >= 0) {
      h_lo = band_lo(v4, a.W, BH);
      nband = band_hi(v4, a.H, BH) - h_lo + 1;
    }
    if (threadIdx.x < R) {
      const bool act = lane < nband;
      const int h = h_lo + lane, wc = v4 - BH * h;
      int freq[NL ? NL : MAX_L], cdf[NL ? NL : MAX_L];
      if (act) cdf_from_logits<NL>(lg + lane * L, L, freq, cdf);
      if (a.mode == 1) {
        // Teacher-forced: the tables do not depend on rANS state.
        int fs = 0, ss = 0;
        if (act) {
          const int sym = a.true_plane[(size_t)b * HW + h * a.W + wc];
          cdf_select<NL>(freq, cdf, L, sym, &fs, &ss);
          q[(h + reach) * W0 + wc + reach] = p.centers[sym];
          if constexpr (RING) ring0[ring_slot(t, h + reach, ns)] = p.centers[sym];
        }
        const size_t o = ((size_t)b * a.T2 + t) * R + lane;
        a.fsel[o] = fs;
        a.ssel[o] = ss;
      } else {
        int sym = 0;
        uint32_t x = st;
        if (act) {
          const uint32_t slot = st & (SCALE - 1u);
          sym = -1;
#pragma unroll
          for (int l = 0; l < (NL ? NL : MAX_L); ++l)
            if (l < L) sym += ((uint32_t)cdf[l] <= slot) ? 1 : 0;
          int fs, ss;
          cdf_select<NL>(freq, cdf, L, sym, &fs, &ss);
          x = (uint32_t)fs * (st >> 16) + slot - (uint32_t)ss;
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
          a.syms_out[(size_t)b * HW + h * a.W + wc] = sym;
          q[(h + reach) * W0 + wc + reach] = p.centers[sym];
          if constexpr (RING) ring0[ring_slot(t, h + reach, ns)] = p.centers[sym];
        }
        gptr += (uint32_t)__popc(mask);
        window_slide(win, stream, a.cap, gptr, base, lane);
      }
    }
    __syncthreads();
    lap(4);
    if constexpr (RING) cur = nxt;
  }
  if (a.prof && threadIdx.x == 0)
    for (int i = 0; i < 5; ++i) a.prof[b * 5 + i] = prof[i];
  if (rans_warp) {
    a.states_out[b * R + lane] = (int)st;
    if (lane == 0) a.gptr_out[b] = (int)gptr;
  }
}

static bool valid(const PlaneArgs& a) {
  if (a.L < 2 || a.L > MAX_L || a.kf < 1 || a.B < 1) return false;
  for (int l = 0; l < 4; ++l)
    if (a.nt[l] < 1 || a.nt[l] > MAX_TAPS) return false;
  return true;
}

// The instance with every width at compile time: K = 5, kf = 24, L = 6.
static bool fast(const PlaneArgs& a) {
  return !(a.force & FORCE_GENERIC) && a.K == 5 && a.kf == 24 && a.L == 6 && a.nt[0] == 12 &&
         a.nt[1] == 13 && a.nt[2] == 13 && a.nt[3] == 13;
}

// Dynamic shared memory: the weights unless wdev, then stage_floats (the
// scan's staged tap rows).
static size_t smem_bytes(const PlaneArgs& a, bool wdev, size_t stage_floats) {
  const size_t np4 = wdev ? 0 : ((size_t)params_size(a.nt, a.kf, a.L) + 3) / 4 * 4;
  return (np4 + stage_floats) * sizeof(float);
}

// Whether the weights stay in device memory for this launch: asked for, or
// `in_smem` with them in shared memory would pass the card's opt-in limit.
static cudaError_t weights_in_device(const void* in_smem, const PlaneArgs& a,
                                     size_t stage_floats, bool* wdev) {
  *wdev = true;
  if (a.force & FORCE_WDEV) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, in_smem);
  if (err == cudaSuccess)
    *wdev = fa.sharedSizeBytes + smem_bytes(a, false, stage_floats) > (size_t)optin;
  return err;
}

// Launch the shared-memory or the device-memory instance of one kernel.
// stage_floats: room behind the weights for the scan's staged tap rows.
template <class Kernel>
static int launch(Kernel in_smem, Kernel in_dev, const PlaneArgs& a, dim3 grid, int threads,
                  cudaStream_t stream, size_t stage_floats = 0) {
  bool wdev;
  cudaError_t err = weights_in_device((const void*)in_smem, a, stage_floats, &wdev);
  if (err != cudaSuccess) return (int)err;
  const Kernel kernel = wdev ? in_dev : in_smem;
  const size_t smem = smem_bytes(a, wdev, stage_floats);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Whether the ring path can run `a` (the wrapper asked for it, a.rslot > 0):
// the compile-time widths with the weights in shared memory, the taps in
// raster order, a slot for every cell of a diagonal of levels 0-3 (and more
// than the two rows below that a tap reaches), and a thread for every (cell,
// channel) of a band of levels 1-4.
static bool ring_ok(const PlaneArgs& a) {
  if (!fast(a) || (a.force & FORCE_WDEV) || a.BH != RING_BH || a.CTR != RING_CTR ||
      a.rslot <= RING_K / 2)
    return false;
  for (int l = 0; l < 4; ++l)
    for (int k = 0; k < a.nt[l]; ++k)
      if (a.tdy[l][k] != k / RING_K || a.tdx[l][k] != k % RING_K) return false;
  for (int l = 0; l <= 4; ++l) {
    const int Hl = a.H + (4 - l) * (RING_K - 1), Wl = a.W + (4 - l) * (RING_K - 1);
    const int bh = (Wl + RING_BH - 1) / RING_BH, cells = Hl < bh ? Hl : bh;
    if ((l < 4 && cells > a.rslot) || (l > 0 && cells * (l < 4 ? a.kf : a.L) > a.threads))
      return false;
  }
  return true;
}

// The scan of one plane (mode 0 decode, mode 1 encode oracle), one block of
// a.threads threads per image: the ring path where the wrapper gives
// a.rslot, else the staged path.
extern "C" int plane_forward(PlaneArgs a, cudaStream_t stream) {
  if (!valid(a) || a.threads < 32 || a.threads > SCAN_MAX_THREADS || a.threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (a.rslot > 0) {
    if (!ring_ok(a)) return (int)cudaErrorInvalidValue;
    const auto kernel = plane_kernel<24, 6, 12, 13, false, true>;
    const size_t smem = smem_bytes(a, false, ring_floats(a.rslot, a.kf));
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<a.B, a.threads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (fast(a))
    return launch(plane_kernel<24, 6, 12, 13, false, false>,
                  plane_kernel<24, 6, 12, 13, true, false>, a, dim3(a.B), a.threads, stream,
                  (size_t)STAGE_CELLS * stage_stride<24, 13>());
  return launch(plane_kernel<0, 0, 0, 0, false, false>, plane_kernel<0, 0, 0, 0, true, false>, a,
                dim3(a.B), a.threads, stream);
}

// The dynamic shared memory a block of the ring path may have: the card's
// opt-in limit less the kernel's static shared memory, in bytes (or a
// negative cudaError). The wrapper takes the ring path where the weights and
// the rings fit in it.
extern "C" int plane_ring_room() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&fa, (const void*)plane_kernel<24, 6, 12, 13, false, true>);
  return err == cudaSuccess ? optin - (int)fa.sharedSizeBytes : -(int)err;
}

// Level a.level (1..4) of all a.B (image, plane) pairs at once: reads level
// a.level - 1 and the level's bias rows, writes the level (level 4: logits).
extern "C" int plane_level(PlaneArgs a, cudaStream_t stream) {
  if (!valid(a) || a.level < 1 || a.level > 4) return (int)cudaErrorInvalidValue;
  const int half = a.K / 2;
  const long cells = (long)(a.H + 2 * (4 - a.level) * half) * (a.W + 2 * (4 - a.level) * half);
  // Work items: (2 cells, 4 or 2 channels) with compile-time widths, else (cell, channel).
  const long items = fast(a) ? (cells + 1) / 2 * (a.level == 4 ? 3 : 6)
                             : cells * (a.level == 4 ? a.L : a.kf);
  long blocks = (items + ENC_THREADS - 1) / ENC_THREADS;
  const long per_pair = 2112 / a.B > 1 ? 2112 / a.B : 1;   // ~16 blocks an SM in all
  blocks = blocks > per_pair ? per_pair : blocks;
  const dim3 grid((unsigned)blocks, a.B);
  if (fast(a))
    return launch(plane_level_kernel<24, 6, 12, 13, false>,
                  plane_level_kernel<24, 6, 12, 13, true>, a, grid, ENC_THREADS, stream);
  return launch(plane_level_kernel<0, 0, 0, 0, false>, plane_level_kernel<0, 0, 0, 0, true>, a,
                grid, ENC_THREADS, stream);
}

// The (freq, start) tables of all a.B (image, plane) pairs from the logits.
extern "C" int plane_tables(PlaneArgs a, cudaStream_t stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)a.B * a.T2 * R;
  size_t blocks = (total + ENC_THREADS - 1) / ENC_THREADS;
  blocks = blocks > 132 * 16 ? 132 * 16 : blocks;
  if (a.L == 6) plane_tables_kernel<6><<<(unsigned)blocks, ENC_THREADS, 0, stream>>>(a);
  else plane_tables_kernel<0><<<(unsigned)blocks, ENC_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Where the weights of the scan (scan = 1) or of a level pass (scan = 0)
// live for the widths in `a`: 1 in device memory, 0 in shared memory, or a
// negative cudaError.
extern "C" int plane_weights_in_device(PlaneArgs a, int scan) {
  bool wdev = false;
  cudaError_t err;
  if (scan && fast(a))
    err = weights_in_device((const void*)plane_kernel<24, 6, 12, 13, false, false>, a,
                            (size_t)STAGE_CELLS * stage_stride<24, 13>(), &wdev);
  else if (scan)
    err = weights_in_device((const void*)plane_kernel<0, 0, 0, 0, false, false>, a, 0, &wdev);
  else
    err = weights_in_device(fast(a) ? (const void*)plane_level_kernel<24, 6, 12, 13, false>
                                    : (const void*)plane_level_kernel<0, 0, 0, 0, false>,
                            a, 0, &wdev);
  return err == cudaSuccess ? (int)wdev : -(int)err;
}
