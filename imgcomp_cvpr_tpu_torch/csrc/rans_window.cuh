// A warp's window on one image's rANS stream words, for the decoding warps
// of kernel 2 (wavefront_forward.cu) and kernel 5 (plane_forward.cu).
//
// The decode pulls at most 32 words a sub-iteration from stream[gptr ...],
// and gptr depends on the sub-iteration before: read from device memory,
// each pull would wait out a device-memory latency on the decode's critical
// chain. The window keeps stream[base, base + 128) in shared memory
// (win[i] = stream[min(base + i, cap - 1)], the clamped read the plain
// version does) and slides by 64 words whenever gptr - base reaches 64, so
// gptr - base < 96 before every sub-iteration and every pull is a
// shared-memory read.

#pragma once

#include <stdint.h>

#define RANS_WIN 128

__device__ __forceinline__ void window_fill(int* win, const int* stream, int cap,
                                            uint32_t base, int from, int lane) {
  for (int i = from + lane; i < RANS_WIN; i += 32) {
    const uint32_t pos = base + (uint32_t)i;
    win[i] = stream[pos < (uint32_t)cap ? pos : (uint32_t)cap - 1u];
  }
  __syncwarp();
}

// Call by the whole warp after gptr moved (gptr is warp-uniform).
__device__ __forceinline__ void window_slide(int* win, const int* stream, int cap,
                                             uint32_t gptr, uint32_t& base, int lane) {
  if (gptr - base >= 64u) {
    const int v0 = win[64 + lane], v1 = win[96 + lane];
    __syncwarp();
    base += 64u;
    win[lane] = v0;
    win[32 + lane] = v1;
    window_fill(win, stream, cap, base, 64, lane);
  }
}
