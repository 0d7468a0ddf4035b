// The planar codec's bias rows (coding/bias_rows.py): for level l = 1..4 of
// plane d, the lower kernel slices of layer l over the kd-1 planes below d,
//
//   row_l[d](h, w, co) = sum over (j, dy, dx, ci) of
//       act_{l-1}[d - kd + 1 + j](h + dy, w + dx, ci) * w_l[j, dy, dx, ci, co]
//     + b_l[co],
//
// with the planes below 0 the all-pad constants (the pad value for q, k1..k3
// for the hidden layers). Kernel 5 (plane_forward.cu) adds the current
// plane's top-slice taps to these rows.
//
// It replaces no Pallas kernel: the JAX package left this sum to XLA
// (conv_lower, imgcomp_cvpr_tpu/coding/planar_codec.py:260-270), and the port
// ran it as cuDNN F.conv2d calls, one image and one plane a call (4 B C a
// batch each way) so that a stream would not depend on the batch. This
// kernel does all (image, plane) pairs of a level in one launch (the encode,
// 4 a batch) or all four levels of one plane of every image (the decode, C a
// batch), reading the activations where kernel 5 leaves them (level 0: the
// padded q planes; levels 1-3: NHWC (H_l, W_l, kf)) and writing the
// (P, H_l, W_l, cout) float32 rows kernel 5 reads.
//
// One fixed order. Every output is one accumulator, acc = fmaf(x, w, acc)
// over (j oldest first, dy, dx, ci) from 0, then acc + b. Which block, tile
// or launch computes it, the batch, and whether the launch is the encode's
// (all planes of a level) or the decode's (one plane, all levels) change
// nothing: a stream decodes alone exactly as it was encoded in a batch, by
// construction. The constant planes go through the same sum.
//
// Bound on the H100: float32 operations (TF32 would not keep the bits the
// container's checks hold). At K = 5, kf = 24 a (image, plane) costs 0.93
// GFLOP over the four levels; ~953 GFLOP a B = 16 Kodak-size round trip,
// 14.2 ms at 67 TFLOP/s; the bytes (each activation read once, each row
// written once) are a tenth of that. So the design is a SIMT implicit GEMM
// (M = cells, N = output channels, K = (j, dy, dx, ci)) fed from shared
// memory:
// - a block owns TILE_CELLS consecutive cells (row-major, across rows) of one
//   (image, plane, level) and all output channels;
// - for each chunk (j, dy) it stages in shared memory the source positions
//   its cells read (one contiguous run of the source plane's rows, ci
//   fastest, rows padded to an odd stride so that neighbouring cells fall
//   in different banks) and the chunk's K x cin x cout weights, then sums the
//   chunk's (dx, ci) steps. Weights stream through shared memory chunk by
//   chunk, at every width (kf = 64 included), and a block needs ~39 KB at
//   kf = 24, so five blocks share an SM;
// - with compile-time widths (K = 5, kf = 24, L = 6, the `pc base` context
//   model) a thread owns MT cells x NT channels (4 x 12 at levels 1-3, 2 x 6
//   at level 4): each weight it reads from shared memory (a broadcast, the
//   warp's channels being the same) serves MT cells and each activation NT
//   channels, so a (dx, ci) step is 4 + 3 shared loads for 48 FMAs. That is
//   the answer to the operand-delivery limit that bounds kernel 5's scan;
// - the generic instance (any other K or width) has the same register tile
//   with run-time K and cin: a thread owns GEN_MT cells x NT channels, NT =
//   16, 8 or 4 picked from cout (16 x 4 = 64 FMAs for 4 + 4 shared loads at
//   kf = 64), the channels padded with zero weights to whole groups of NT.
//   It streams the weights one (j, dy, dx) slice at a time through two
//   shared buffers with cp.async, the next slice in flight while one is
//   summed, so a block needs ~68 KB at kf = 64 and one barrier a slice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "layer_sum.cuh"

#define MAX_J 3           // kd - 1 planes below (K <= 7)
#define MAX_LEVELS 4
#define BR_THREADS 128
#define TILE_CELLS 256    // cells a block (compile-time widths)
#define GEN_MT 4          // cells a thread (generic instance)
#define FORCE_GENERIC 2   // the generic instance even where a fixed one exists

// One level of a launch. Output plane i (0..D-1) of image b reads, as its
// tap plane j, the constant cval where i + j < nconst, else
// src[j] + b * src_img + (i + off[j]) * src_plane (an (Hs, Ws, cin) plane).
// Encode: src[j] = the level below of all B x C pairs, off[j] = j - (kd-1),
// src_plane = one plane, nconst = kd - 1. Decode: src[j] = the j-th plane of
// the history (null below plane 0), off = 0, D = 1.
struct BiasLevel {
  const float* src[MAX_J];
  long long off[MAX_J];
  long long src_img, src_plane;
  const float* cval;   // (cin,) the constant planes' value
  const float* w;      // (kd - 1, K, K, cin, cout)
  const float* bias;   // (cout,)
  float* out;          // image b, plane i at out + b * out_img + i * out_plane
  long long out_img, out_plane;
  int level, nconst, Hs, Ws, Hl, Wl, cin, cout;
  int tiles, block0;   // set by the host entry: tiles a pair, first block
};

struct BiasArgs {
  BiasLevel lv[MAX_LEVELS];
  int nlev, B, D, K, kd1, force;
};

// A block's cells [c0, c0 + nc) of the Hl x Wl grid. Chunk (j, dy) stages
// `span` source positions from s_lo = (h0 + dy) * Ws + w0 on.
struct Tile {
  int c0, nc, h0, w0, span;
};

__device__ __forceinline__ Tile make_tile(const BiasLevel& L, int tile, int NC, int K) {
  Tile t;
  t.c0 = tile * NC;
  t.nc = min(NC, L.Hl * L.Wl - t.c0);
  t.h0 = t.c0 / L.Wl;
  t.w0 = t.c0 % L.Wl;
  const int cl = t.c0 + t.nc - 1;
  t.span = (cl / L.Wl - t.h0) * L.Ws + (cl % L.Wl - t.w0) + K;
  return t;
}

// Cell c's first source position, relative to the staged run.
__device__ __forceinline__ int cell_pos(const BiasLevel& L, const Tile& t, int c) {
  const int a = t.c0 + c;
  return (a / L.Wl - t.h0) * L.Ws + (a % L.Wl - t.w0);
}

// Stage tap plane j's run of chunk row dy for output plane i of image b:
// xs[q * XS + ci] = source position s_lo + q, channel ci.
template <int CIN>
__device__ __forceinline__ void stage_x(float* xs, const BiasLevel& L, const Tile& t, int j,
                                        int dy, int b, int i, int XS) {
  const int cin = CIN > 0 ? CIN : L.cin;
  if (i + j < L.nconst || L.src[j] == nullptr) {
    for (int e = threadIdx.x; e < t.span * cin; e += blockDim.x)
      xs[(e / cin) * XS + e % cin] = L.cval[e % cin];
    return;
  }
  const float* p = L.src[j] + b * L.src_img + (i + L.off[j]) * L.src_plane +
                   ((long long)(t.h0 + dy) * L.Ws + t.w0) * cin;
  if constexpr (CIN > 0 && CIN % 4 == 0) {
    constexpr int V = CIN / 4;
    for (int e = threadIdx.x; e < t.span * V; e += blockDim.x) {
      const float4 v = reinterpret_cast<const float4*>(p)[e];
      float* d = xs + (e / V) * XS + (e % V) * 4;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < t.span * cin; e += blockDim.x)
      xs[(e / cin) * XS + e % cin] = p[e];
  }
}

// n floats from device memory to shared memory (both 16-byte aligned when
// VEC).
template <bool VEC>
__device__ __forceinline__ void stage_w(float* ws, const float* w, int n) {
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
      reinterpret_cast<float4*>(ws)[e] = reinterpret_cast<const float4*>(w)[e];
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) ws[e] = w[e];
  }
}

// Compile-time widths: a thread owns MT cells (lane, lane + TPG, ...) x NT
// consecutive output channels; the warps of a channel group read the same
// weights.
template <int CIN, int COUT, int K, int NT, int MT>
__device__ __forceinline__ void tile_fast(const BiasLevel& L, int kd1, int b, int i, int tile,
                                          float* sm) {
  constexpr int G = COUT / NT, TPG = BR_THREADS / G, XS = CIN | 1, WN = K * CIN * COUT;
  static_assert(TPG * MT == TILE_CELLS && TPG % 32 == 0 && WN % 4 == 0, "tile shape");
  const Tile t = make_tile(L, tile, TILE_CELLS, K);
  float* ws = sm;
  float* xs = sm + WN;
  const int g = threadIdx.x / TPG, lane = threadIdx.x % TPG, co0 = g * NT;
  int pos[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int c = lane + m * TPG;
    pos[m] = cell_pos(L, t, c < t.nc ? c : 0) * XS;   // past the grid's end: cell 0's
  }
  float acc[MT][NT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[m][n] = 0.f;
  for (int j = 0; j < kd1; ++j) {
    for (int dy = 0; dy < K; ++dy) {
      __syncthreads();                       // the last chunk's reads are done
      stage_w<true>(ws, L.w + (size_t)(j * K + dy) * WN, WN);
      stage_x<CIN>(xs, L, t, j, dy, b, i, XS);
      __syncthreads();
#pragma unroll 1
      for (int dx = 0; dx < K; ++dx) {
        const float* xr = xs + dx * XS;
        const float* wr = ws + dx * CIN * COUT + co0;
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          float wv[NT];
          load_w<NT>(wr + ci * COUT, wv);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = xr[pos[m] + ci];
#pragma unroll
            for (int n = 0; n < NT; ++n) acc[m][n] = fmaf(xv, wv[n], acc[m][n]);
          }
        }
      }
    }
  }
  float* out = L.out + b * L.out_img + i * L.out_plane;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int c = lane + m * TPG;
    if (c < t.nc) {
      float v[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) v[n] = __fadd_rn(acc[m][n], L.bias[co0 + n]);
      float* o = out + (size_t)(t.c0 + c) * COUT + co0;
      if constexpr (NT % 4 == 0) {
#pragma unroll
        for (int n = 0; n < NT; n += 4)
          *reinterpret_cast<float4*>(o + n) = make_float4(v[n], v[n + 1], v[n + 2], v[n + 3]);
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) o[n] = v[n];
      }
    }
  }
}

// The generic instance's tile for cout output channels: NT channels a
// thread, G = ceil(cout / NT) channel groups of TPG = BR_THREADS / G threads
// (the last BR_THREADS - G x TPG threads idle), NC cells a block, weight rows
// padded to WS = G x NT.
struct GenShape {
  int nt, g, tpg, nc, ws;
};

__host__ __device__ inline GenShape gen_shape(int cout) {
  GenShape s;
  s.nt = cout >= 32 ? 16 : cout > 8 ? 8 : 4;
  s.g = (cout + s.nt - 1) / s.nt;
  s.tpg = BR_THREADS / s.g;
  s.nc = s.tpg * GEN_MT < TILE_CELLS ? s.tpg * GEN_MT : TILE_CELLS;
  s.ws = s.g * s.nt;
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Start copying one (j, dy, dx) weight slice (cin, cout) into rows of ws_row
// floats (the padding channels are zeroed once, never copied).
__device__ __forceinline__ void issue_w(float* ws, const float* w, int cin, int cout,
                                        int ws_row) {
  if (ws_row == cout && cout % 4 == 0) {
    for (int e = threadIdx.x; e < cin * cout / 4; e += blockDim.x)
      cp_async16(ws + 4 * e, w + 4 * e);
  } else {
    for (int e = threadIdx.x; e < cin * cout; e += blockDim.x)
      cp_async4(ws + (e / cout) * ws_row + e % cout, w + e);
  }
}

// Start copying tap plane j's run of chunk row dy (stage_x's layout); the
// constant planes are plain stores.
__device__ __forceinline__ void issue_x(float* xs, const BiasLevel& L, const Tile& t, int j,
                                        int dy, int b, int i, int XS) {
  const int cin = L.cin;
  if (i + j < L.nconst || L.src[j] == nullptr) {
    for (int e = threadIdx.x; e < t.span * cin; e += blockDim.x)
      xs[(e / cin) * XS + e % cin] = L.cval[e % cin];
    return;
  }
  const float* p = L.src[j] + b * L.src_img + (i + L.off[j]) * L.src_plane +
                   ((long long)(t.h0 + dy) * L.Ws + t.w0) * cin;
  for (int e = threadIdx.x; e < t.span * cin; e += blockDim.x)
    cp_async4(xs + (e / cin) * XS + e % cin, p + e);
}

// Any widths: the register tile of tile_fast with run-time K, cin and cout,
// and the same order of sums. The copies are asynchronous (cp.async): weight
// slice s + 1 is in flight while slice s is summed. Slice s sits in buffer
// s % 2, which slice s + 2 overwrites only once every thread is past the
// barrier of slice s + 1, so one barrier a slice, and one a chunk for xs.
template <int NT>
__device__ __forceinline__ void tile_gen(const BiasLevel& L, int K, int kd1, int b, int i,
                                         int tile, float* sm) {
  const int cin = L.cin, cout = L.cout, XS = cin | 1;
  const GenShape s = gen_shape(cout);
  const Tile t = make_tile(L, tile, s.nc, K);
  const int wn = cin * s.ws;                 // a multiple of 4: NT is
  const size_t slice_w = (size_t)cin * cout;
  float* xs = sm + 2 * wn;
  const int g = threadIdx.x / s.tpg, lane = threadIdx.x % s.tpg, co0 = g * NT;
  const bool on = g < s.g;
  if (s.ws != cout)
    for (int e = threadIdx.x; e < 2 * cin * (s.ws - cout); e += blockDim.x) {
      const int r = e / (s.ws - cout);
      sm[(r / cin) * wn + (r % cin) * s.ws + cout + e % (s.ws - cout)] = 0.f;
    }
  issue_w(sm, L.w, cin, cout, s.ws);
  cp_async_commit();
  int pos[GEN_MT];
#pragma unroll
  for (int m = 0; m < GEN_MT; ++m) {
    const int c = lane + m * s.tpg;
    pos[m] = cell_pos(L, t, c < t.nc ? c : 0) * XS;   // past the tile's end: cell 0's
  }
  float acc[GEN_MT][NT];
#pragma unroll
  for (int m = 0; m < GEN_MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[m][n] = 0.f;
  const int slices = kd1 * K * K;
  for (int sl = 0; sl < slices; ++sl) {
    const int dx = sl % K;
    if (dx == 0) {
      __syncthreads();                       // the last chunk's reads of xs are done
      issue_x(xs, L, t, sl / (K * K), (sl / K) % K, b, i, XS);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();                         // slice sl and xs landed; slice sl - 1 summed
    if (sl + 1 < slices) {
      issue_w(sm + ((sl + 1) & 1) * wn, L.w + (sl + 1) * slice_w, cin, cout, s.ws);
      cp_async_commit();
    }
    if (on) {
      const float* xr = xs + dx * XS;
      const float* wr = sm + (sl & 1) * wn + co0;
#pragma unroll 2
      for (int ci = 0; ci < cin; ++ci) {
        float wv[NT];
        load_w<NT>(wr + ci * s.ws, wv);
#pragma unroll
        for (int m = 0; m < GEN_MT; ++m) {
          const float xv = xr[pos[m] + ci];
#pragma unroll
          for (int n = 0; n < NT; ++n) acc[m][n] = fmaf(xv, wv[n], acc[m][n]);
        }
      }
    }
  }
  if (!on) return;
  float* out = L.out + b * L.out_img + i * L.out_plane;
#pragma unroll
  for (int m = 0; m < GEN_MT; ++m) {
    const int c = lane + m * s.tpg;
    if (c < t.nc) {
      float* o = out + (size_t)(t.c0 + c) * cout;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (co0 + n < cout) o[co0 + n] = __fadd_rn(acc[m][n], L.bias[co0 + n]);
    }
  }
}

template <bool FAST>
__global__ void __launch_bounds__(BR_THREADS) bias_rows_kernel(BiasArgs a) {
  extern __shared__ __align__(16) float sm[];
  int v = 0;
  while (v + 1 < a.nlev && (int)blockIdx.x >= a.lv[v + 1].block0) ++v;
  const BiasLevel& L = a.lv[v];
  const int local = blockIdx.x - L.block0, tile = local % L.tiles, pair = local / L.tiles;
  const int b = pair / a.D, i = pair % a.D;
  if constexpr (FAST) {
    if (L.level == 1) tile_fast<1, 24, 5, 12, 4>(L, a.kd1, b, i, tile, sm);
    else if (L.level == 4) tile_fast<24, 6, 5, 6, 2>(L, a.kd1, b, i, tile, sm);
    else tile_fast<24, 24, 5, 12, 4>(L, a.kd1, b, i, tile, sm);
  } else {
    const int nt = gen_shape(L.cout).nt;
    if (nt == 16) tile_gen<16>(L, a.K, a.kd1, b, i, tile, sm);
    else if (nt == 8) tile_gen<8>(L, a.K, a.kd1, b, i, tile, sm);
    else tile_gen<4>(L, a.K, a.kd1, b, i, tile, sm);
  }
}

// The instance with every width at compile time: K = 5, kf = 24, L = 6.
static bool fast(const BiasArgs& a) {
  if ((a.force & FORCE_GENERIC) || a.K != 5 || a.kd1 != 2) return false;
  for (int v = 0; v < a.nlev; ++v) {
    const BiasLevel& L = a.lv[v];
    if (L.cin != (L.level == 1 ? 1 : 24) || L.cout != (L.level == 4 ? 6 : 24)) return false;
  }
  return true;
}

// Shared memory of one block of level L: the weights of a chunk (two
// slices, generic) and the largest staged run (cells NC - 1 apart span at
// most (NC + Wl - 2) / Wl row breaks).
static size_t smem_bytes(bool f, const BiasLevel& L, int K) {
  const int NC = f ? TILE_CELLS : gen_shape(L.cout).nc;
  const size_t wn = f ? (size_t)K * L.cin * L.cout : 2 * (size_t)L.cin * gen_shape(L.cout).ws;
  const size_t span = (size_t)NC - 1 + (size_t)(K - 1) * ((NC + L.Wl - 2) / L.Wl) + K;
  return (wn + span * (L.cin | 1)) * sizeof(float);
}

// The bias rows of a.nlev levels of a.B images x a.D planes, one launch.
extern "C" int bias_rows(BiasArgs a, cudaStream_t stream) {
  if (a.nlev < 1 || a.nlev > MAX_LEVELS || a.B < 1 || a.D < 1 || a.K < 1 || a.kd1 < 1 ||
      a.kd1 > MAX_J)
    return (int)cudaErrorInvalidValue;
  const bool f = fast(a);
  long long blocks = 0;
  size_t smem = 0;
  for (int v = 0; v < a.nlev; ++v) {
    BiasLevel& L = a.lv[v];
    if (L.level < 1 || L.level > 4 || L.cin < 1 || L.cout < 1 ||
        gen_shape(L.cout).tpg < 1 || ((uintptr_t)L.w & 15) || L.Hl < 1 || L.Wl < 1 ||
        L.Hs != L.Hl + a.K - 1 || L.Ws != L.Wl + a.K - 1)
      return (int)cudaErrorInvalidValue;
    const int NC = f ? TILE_CELLS : gen_shape(L.cout).nc;
    L.tiles = (L.Hl * L.Wl + NC - 1) / NC;
    L.block0 = (int)blocks;
    blocks += (long long)a.B * a.D * L.tiles;
    const size_t s = smem_bytes(f, L, a.K);
    smem = s > smem ? s : smem;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  void (*kernel)(BiasArgs) = f ? bias_rows_kernel<true> : bias_rows_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, BR_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
