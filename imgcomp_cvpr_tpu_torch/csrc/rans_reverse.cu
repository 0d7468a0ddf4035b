// Reverse interleaved rANS encoder (kernel 3 of the port; kernel 6 is the
// same source driven over the planar rows).
//
// Replaces the TPU kernels imgcomp_cvpr_tpu/coding/pallas_kernel.py::
// make_reverse (pl.pallas_call at :1362) and imgcomp_cvpr_tpu/coding/
// planar_kernel.py::make_plane_reverse (:540), and mirrors
// rans.encode_reverse_scan_interleaved: 32 lanes of one image walk the
// (freq, start) tables row by row in reverse coding order; lane r holds rANS
// state r (seeded at x0: 1 for tail packing, RANS_L for the classic seed) and
// counts its warmup symbols k (pre-renorm state below RANS_L, x0 < RANS_L
// only). Emitting lanes of a sub-iteration write their 16-bit renorm words
// in DESCENDING lane rank (ranked with __ballot_sync/__popc) so that
// reversing the whole buffer restores the decoder's read order. f < 1 is
// clamped to 1; words at pos >= cap are dropped but counted. Fed the same
// tables, words, n_words, final states and k are byte-identical to the
// Pallas kernels' and to the plain version (coding/cuda_kernel.py::
// reverse_plain_list).
//
// What bounds it on the H100: not bytes (the tables are read once, ~0.02 ms
// at 3.35 TB/s for a B=16 Kodak-size batch) but the chain of dependent state
// updates of one image, which the format fixes at R = 32 lanes: one image is
// one block, and the chain cannot be split. The block's four warps keep
// everything but that chain off the chain warp (warp 0):
//  * a host-built list of the non-empty sub-iterations in coding order
//    (index of the 32-lane row in the (rows, 32) view of the table, and its
//    32-bit active mask; coding/cuda_kernel.py::reverse_list), padded with
//    empty entries to whole tiles: nothing loads an activity table, votes on
//    it or walks an empty sub-iteration;
//  * two producer warps (1 and 3, alternate tiles) stage tiles of TE
//    consecutive list entries into a ring of NSLOT shared-memory slots,
//    LEAD tiles ahead, with cp.async: lane l copies the f row (l even) or the
//    s row (l odd) of entry l / 2 as 8 16-byte copies, plus the tile's masks,
//    and the slot's `full` barrier counts the copies in
//    (cp.async.mbarrier.arrive). Per-lane cp.async costs the warp ~10
//    instructions a tile; 1D bulk copies (cp.async.bulk) of single 128-byte
//    rows are issued one lane at a time through the uniform datapath (~10
//    instructions a row), which made the producer, not the chain, the bound;
//  * the producer then turns each lane's (f, s) into the row parameters
//    {thr, m, nf, s}, one 16-byte word the chain loads at once: the
//    reciprocal m (the compiler's 32-bit division, 16 independent ones a
//    tile, so their latencies overlap; a 256 KB table of reciprocals lost to
//    its uncoalesced gathers), nf = -f and the renormalisation threshold.
//    Inactive lanes, and the padding entries, take f = 65536, s = 0 and a
//    threshold no state passes: their update is the identity, so the chain
//    has no select on activity and no bounds check;
//  * the chain warp loads a tile's parameters into registers and runs its
//    TE updates (rdiv_update: an exact division by the reciprocal instead of
//    the emulated 32-bit division), writing each lane's renorm word, flagged
//    with bit 16 when it emits, to the slot;
//  * the writer warp (2) ranks those words with __ballot_sync / __popc and
//    writes them to the stream, one tile behind the chain, and releases the
//    slot to the producers.
// An optional profile (B, NPROF) records, per image: the chain warp's clocks,
// its clocks waiting for tiles, the sub-iterations run, each producer's and
// the writer's clocks waiting, and the chain warp's clocks in its updates.

#include <cuda_runtime.h>
#include <stdint.h>

#define R 32
#define RANS_L 65536u
#define TE 16               // list entries (non-empty sub-iterations) a tile: one
                            // row of f or s a producer lane; divides the list's
                            // padding (coding/cuda_kernel.py::REVERSE_LIST_PAD)
#define NSLOT 12            // tiles in the ring (even: a producer keeps to its slots)
#define LEAD 6              // tiles the copies run ahead of the preparation, which
                            // can then run up to NSLOT - LEAD - 2 tiles ahead of
                            // the chain (the chain and the writer hold 2); even
#define NPROF 7             // profile columns an image

// One slot of the ring: the copies write f, s (one 128-byte row per entry)
// and mask; the producer writes p; the chain writes w.
struct Tile {
  uint32_t f[TE][R];  // copied f rows
  uint32_t s[TE][R];  // copied s rows
  uint4 p[TE][R];     // prepared: {thr, m, nf, s}; emit iff st > thr
  uint32_t w[TE][R];  // 0x10000 | word where the lane emitted, else 0
  unsigned mask[TE];  // copied lane masks
};
#define SMEM_BYTES (NSLOT * sizeof(Tile) + 4 * NSLOT * sizeof(uint64_t))

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The rANS update x -> ((x / f) << 16) + (x % f) + s (mod 2^32), with nf =
// -f and the quotient from the reciprocal m = floor((2^32 - 1) / f): exact
// for every f in [1, 65536] and every x < 2^32. q0 = floor(x m / 2^32) never
// exceeds floor(x / f) (m <= 2^32 / f) and falls short by at most one (m >
// 2^32 / f - 1, so x m / 2^32 > x / f - x / 2^32 > x / f - 1); one
// correction (r0 = x - q0 f >= f) gives the quotient. With g = 65536 - f,
// (q << 16) + (x - q f) + s = q g + x + s, so the corrected result is the
// uncorrected one plus g. coding/cuda_kernel.py::rdiv_update is the numpy
// twin that the CPU tests hold to // and %.
// Written in PTX so that the compiler keeps the dependent chain at mul.hi ->
// mad (r0) -> setp -> add, with y and y + g computed beside it (in C++ it
// shares q0 * nf between r0 and y and adds two steps to the chain).
__device__ __forceinline__ uint32_t rdiv_update(uint32_t x, uint32_t m, uint32_t nf,
                                                uint32_t s) {
  const uint32_t g = nf + 65536u, f = 0u - nf, xs = x + s;
  uint32_t out;
  asm("{\n .reg .u32 q, r, y, z;\n .reg .pred p;\n"
      " mul.hi.u32 q, %1, %2;\n"
      " mad.lo.u32 r, q, %3, %1;\n"
      " mad.lo.u32 y, q, %4, %5;\n"
      " add.u32 z, y, %4;\n"
      " setp.ge.u32 p, r, %6;\n"
      " selp.u32 %0, z, y, p;\n}\n"
      : "=r"(out)
      : "r"(x), "r"(m), "r"(nf), "r"(g), "r"(xs), "r"(f));
  return out;
}

__global__ void __launch_bounds__(4 * R, 1)
    rans_reverse_kernel(int rows, int E, int cap, uint32_t x0,
                        const int* __restrict__ list_row,
                        const unsigned* __restrict__ list_mask,
                        const int* __restrict__ fsel, const int* __restrict__ ssel,
                        int* words, int* n_words, int* states_out, int* k_out,
                        long long* prof) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tile* ring = reinterpret_cast<Tile*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NSLOT * sizeof(Tile));
  uint64_t* ready = full + NSLOT;
  uint64_t* done = ready + NSLOT;
  uint64_t* empty = done + NSLOT;
  const int b = blockIdx.x, warp = threadIdx.x / R, lane = threadIdx.x % R;
  const int ntiles = (E + TE - 1) / TE;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NSLOT; ++i) {
      mbar_init(&full[i], R);   // one copies_arrive per lane of the tile's producer
      mbar_init(&ready[i], R);  // each of its lanes releases its writes
      mbar_init(&done[i], R);   // each chain lane releases its words
      mbar_init(&empty[i], 1);  // the writer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 1 || warp == 3) {
    // Producers: warp 1 takes the even tiles, warp 3 the odd ones (NSLOT
    // and LEAD are even, so each keeps to its own slots). issue(k) stages
    // tile k into slot k % NSLOT once the writer has released tile
    // k - NSLOT (the list is padded to whole tiles with row 0 and mask 0, so
    // every lane copies); its entry rows are loaded one tile ahead. Then
    // tile i's (f, s) become the chain's row parameters.
    const int par = warp == 1 ? 0 : 1;
    const int je = lane >> 1;
    const int* tab = ((lane & 1) ? ssel : fsel) + (size_t)b * rows * R;
    int row = par < ntiles ? __ldg(list_row + par * TE + je) : 0;
    long long pw = 0;
    auto issue = [&](int k) {
      const int slot = k % NSLOT;
      const int next = k + 2 < ntiles ? __ldg(list_row + (k + 2) * TE + je) : 0;
      if (k >= NSLOT) {
        const long long w0 = clock64();
        mbar_wait(&empty[slot], (k / NSLOT - 1) & 1);
        pw += clock64() - w0;
      }
      Tile& t = ring[slot];
      unsigned char* dst = (unsigned char*)((lane & 1) ? t.s[je] : t.f[je]);
      const unsigned char* src = (const unsigned char*)(tab + (size_t)row * R);
#pragma unroll
      for (int c = 0; c < 8; ++c) copy16(dst + 16 * c, src + 16 * c);
      if (lane < TE) copy4(&t.mask[lane], list_mask + k * TE + lane);
      copies_arrive(&full[slot]);
      row = next;
    };
    for (int k = par; k < LEAD && k < ntiles; k += 2) issue(k);
    for (int i = par; i < ntiles; i += 2) {
      if (i + LEAD < ntiles) issue(i + LEAD);
      const int slot = i % NSLOT;
      Tile& t = ring[slot];
      const long long w0 = clock64();
      mbar_wait(&full[slot], (i / NSLOT) & 1);
      pw += clock64() - w0;
      // Loads, then the TE independent divisions, then the stores: kept
      // apart so that the compiler overlaps the divisions' latencies.
      uint32_t f[TE], m[TE], sv[TE];
#pragma unroll
      for (int e = 0; e < TE; ++e) {
        const bool act = (t.mask[e] >> lane) & 1u;
        const int fi = (int)t.f[e][lane];
        f[e] = act ? (uint32_t)min(max(fi, 1), 65536) : 65536u;
        sv[e] = act ? t.s[e][lane] : 0u;
      }
#pragma unroll
      for (int e = 0; e < TE; ++e) m[e] = 0xFFFFFFFFu / f[e];
#pragma unroll
      for (int e = 0; e < TE; ++e)  // thr is 0xFFFFFFFF at f = 65536: never
        t.p[e][lane] = make_uint4((f[e] << 16) - 1u, m[e], 0u - f[e], sv[e]);
      mbar_arrive(&ready[slot]);  // each lane releases its own writes
    }
    if (prof && lane == 0) prof[b * NPROF + 3 + par] = pw;
    return;
  }

  if (warp == 2) {
    // Writer: ranks and stores the words of each tile the chain has run.
    int* wo = words + (size_t)b * cap;
    const unsigned below = (1u << lane) - 1u;
    uint32_t gw = 0;
    long long ww = 0;
    for (int k = 0; k < ntiles; ++k) {
      const int slot = k % NSLOT;
      const long long w0 = clock64();
      mbar_wait(&done[slot], (k / NSLOT) & 1);
      ww += clock64() - w0;
      const Tile& t = ring[slot];
#pragma unroll
      for (int e = 0; e < TE; ++e) {
        const uint32_t v = t.w[e][lane];
        const bool emit = v >> 16;
        const unsigned em = __ballot_sync(0xffffffffu, emit);
        const uint32_t total = __popc(em);
        const uint32_t pos = gw + total - 1u - __popc(em & below);
        if (emit && pos < (uint32_t)cap) wo[pos] = (int)(v & 0xFFFFu);
        gw += total;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    if (lane == 0) {
      n_words[b] = (int)gw;
      if (prof) prof[b * NPROF + 5] = ww;
    }
    return;
  }

  // The chain warp: per tile, the prepared parameters into registers, then
  // TE state updates with nothing else on the chain.
  const bool tail = x0 < RANS_L;
  uint32_t st = x0;
  int kc = 0;
  long long waited = 0, updating = 0;
  const long long t0 = clock64();
  for (int k = 0; k < ntiles; ++k) {
    const int slot = k % NSLOT;
    const long long w0 = clock64();
    mbar_wait(&ready[slot], (k / NSLOT) & 1);
    waited += clock64() - w0;
    Tile& t = ring[slot];
    uint4 rp[TE];
    uint32_t mk[TE];
#pragma unroll
    for (int e = 0; e < TE; ++e) {
      rp[e] = t.p[e][lane];
      mk[e] = t.mask[e];
    }
    const long long u0 = clock64();
#pragma unroll
    for (int e = 0; e < TE; ++e) {
      if (tail && ((mk[e] >> lane) & 1u) && st < RANS_L) ++kc;
      const bool emit = st > rp[e].x;
      t.w[e][lane] = emit ? 0x10000u | (st & 0xFFFFu) : 0u;
      st = rdiv_update(emit ? st >> 16 : st, rp[e].y, rp[e].z, rp[e].w);
    }
    updating += clock64() - u0;
    mbar_arrive(&done[slot]);
  }
  states_out[b * R + lane] = (int)st;
  k_out[b * R + lane] = kc;
  if (prof && lane == 0) {
    prof[b * NPROF + 0] = clock64() - t0;
    prof[b * NPROF + 1] = waited;
    prof[b * NPROF + 2] = E;
    prof[b * NPROF + 6] = updating;
  }
}

// rows: 32-lane rows of one image's table (fsel / ssel are (B, rows, 32)
// int32, 16-byte aligned); list_row int32 and list_mask uint32: the E
// non-empty rows in coding order and their lane masks, padded to a multiple
// of TE entries with row 0 and mask 0. prof: null or (B, NPROF) int64.
extern "C" int rans_reverse(int B, int rows, int E, int cap, unsigned x0,
                            const int* list_row, const unsigned* list_mask,
                            const int* fsel, const int* ssel,
                            int* words, int* n_words, int* states, int* k,
                            long long* prof, cudaStream_t stream) {
  if (B < 1 || E < 0 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rans_reverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  rans_reverse_kernel<<<B, 4 * R, SMEM_BYTES, stream>>>(rows, E, cap, x0, list_row,
                                                       list_mask, fsel, ssel, words,
                                                       n_words, states, k, prof);
  return (int)cudaGetLastError();
}
