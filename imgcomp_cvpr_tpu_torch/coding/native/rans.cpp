// Host reverse-rANS runtime (port of imgcomp_cvpr_tpu/coding/native/rans.cpp).
//
// Given per (step, lane) the coded symbol's (freq, cdf_low) in 16-bit
// precision, the encoder is a reverse (LIFO) pass over those tables: pure
// integer work for the host. rans.encode_reverse binds rans_encode_reverse;
// its numpy loop (native=False) is the plain version, byte for byte the
// same. No codec path of the port calls it: the CUDA codecs encode with
// kernels 3 and 6, and the scan codecs with the torch
// rans.encode_reverse_scan_interleaved on their own device. It is the host
// encoder of rans.encode_reverse, as in the JAX package.
//
// Layout contracts (kept in sync with coding/rans.py):
//   state: uint32 in [2^16, 2^32); SCALE_BITS = 16; 16-bit renorm words;
//   encode emits at most one word per symbol; per-lane streams are stored
//   in decode-read order (reverse of emission order).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 rans.cpp -o librans-<hash>.so
// (coding/native/build.py, into build/native/ at the repository root).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kScaleBits = 16;
constexpr uint32_t kWordBits = 16;
constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kWordMask = (1u << kWordBits) - 1;

}  // namespace

extern "C" {

// Reverse-encode M interleaved lanes over T steps.
//  freqs, starts: row-major (T, M) uint32 — tables of the coded symbol.
//  active:        (T, M) uint8.
//  x0:            initial encoder state. kRansL is the classic seed;
//                 x0 = 1 enables tail packing (container v8): the seed's
//                 16 a-priori-known bits stop flowing through the stream,
//                 at the cost of a per-lane warmup of k symbols whose
//                 renorm pulls the decoder must suppress (out_k).
//  out_words:     (M, T) uint16 — per-lane streams in decode-read order
//                 (row j holds lane j's words, front-aligned).
//  out_lens:      (M,) uint32 — words per lane.
//  out_states:    (M,) uint32 — final encoder states (decoder init).
//  out_k:         (M,) int32 — warmup symbol counts (0 when x0 >= kRansL).
void rans_encode_reverse(int64_t T, int64_t M,
                         const uint32_t* freqs, const uint32_t* starts,
                         const uint8_t* active, uint32_t x0,
                         uint16_t* out_words, uint32_t* out_lens,
                         uint32_t* out_states, int32_t* out_k) {
  std::vector<uint32_t> state(M, x0);
  std::vector<int32_t> warm(M, 0);
  // Emission order is reverse of decode order; collect backwards per lane.
  std::vector<std::vector<uint16_t>> emitted(M);
  for (int64_t j = 0; j < M; ++j) emitted[j].reserve(T / 4 + 4);

  for (int64_t t = T - 1; t >= 0; --t) {
    const uint32_t* f_row = freqs + t * M;
    const uint32_t* s_row = starts + t * M;
    const uint8_t* a_row = active + t * M;
    for (int64_t j = 0; j < M; ++j) {
      if (!a_row[j]) continue;
      uint32_t x = state[j];
      const uint32_t f = f_row[j] ? f_row[j] : 1;
      if (x < kRansL) ++warm[j];  // emission below is impossible here
      if ((uint64_t)x >= ((uint64_t)f << kWordBits)) {
        emitted[j].push_back(static_cast<uint16_t>(x & kWordMask));
        x >>= kWordBits;
      }
      state[j] = ((x / f) << kScaleBits) + (x % f) + s_row[j];
    }
  }
  for (int64_t j = 0; j < M; ++j) {
    const auto& e = emitted[j];
    const int64_t n = static_cast<int64_t>(e.size());
    out_lens[j] = static_cast<uint32_t>(n);
    uint16_t* row = out_words + j * T;
    for (int64_t i = 0; i < n; ++i) row[i] = e[n - 1 - i];  // reverse
    out_states[j] = state[j];
    out_k[j] = warm[j];
  }
}

}  // extern "C"
