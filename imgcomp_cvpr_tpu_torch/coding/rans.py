"""Interleaved rANS primitives (port of imgcomp_cvpr_tpu/coding/rans.py).

- state: uint32 in [2^16, 2^32) (below 2^16 only during an x0=1 warmup);
  16-bit renormalization words;
- per-symbol frequency tables sum to SCALE = 2^16;
- encode runs in reverse symbol order, decode forward.

torch has thin uint32 support, so the torch twins keep states in int64 and
mask to 32 bits where the uint32 arithmetic would wrap. The numpy scalar
codec is the test oracle for the rANS math itself.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

SCALE_BITS = 16
SCALE = 1 << SCALE_BITS
RANS_L = 1 << 16
WORD_BITS = 16
WORD_MASK = (1 << WORD_BITS) - 1
MASK32 = 0xFFFFFFFF


def quantize_cdf(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., L) float probs -> (freq, cdf_low) int64 with sum(freq) == SCALE:
    floor(p * (SCALE - L)) + 1 per symbol, the remainder to the lowest-index
    argmax. A NaN probability converts to 0 (XLA's and the card's float to
    int conversion), so it gets freq 1; a column holding one has no p equal
    to its max, so it takes no remainder and sums to L (see
    cuda_kernel.logits_to_cdf)."""
    L = probs.shape[-1]
    floored = torch.floor(probs * float(SCALE - L))
    scaled = torch.where(torch.isnan(floored), 0.0, floored).long() + 1
    deficit = SCALE - scaled.sum(-1, keepdim=True)
    pmax = probs.max(-1, keepdim=True).values
    lidx = torch.arange(L, device=probs.device)
    am = torch.where(probs == pmax, lidx, L).min(-1, keepdim=True).values
    freq = scaled + torch.where(lidx == am, deficit, 0)
    return freq, torch.cumsum(freq, -1) - freq


# ---------------------------------------------------------------------------
# Scalar reference codec (numpy) — test oracle
# ---------------------------------------------------------------------------

def scalar_encode(symbols: np.ndarray, freqs: np.ndarray, cdf_lows: np.ndarray,
                  x0: int = RANS_L) -> Tuple[List[int], int, int]:
    """Encode one lane; returns (words in decode-read order, final state, k).
    x0 < RANS_L is tail packing: the first k encoded symbols (the decoder's
    last k) are a warmup that emits nothing."""
    x = x0
    k = 0
    emitted: List[int] = []
    for i in range(len(symbols) - 1, -1, -1):
        s = int(symbols[i])
        f = int(freqs[i, s])
        start = int(cdf_lows[i, s])
        if x < RANS_L:
            k += 1
        if x >= (f << WORD_BITS):
            emitted.append(x & WORD_MASK)
            x >>= WORD_BITS
        x = ((x // f) << SCALE_BITS) + (x % f) + start
    return emitted[::-1], x, k


def scalar_decode(words: List[int], state: int, freqs: np.ndarray,
                  cdf_lows: np.ndarray, k: int = 0) -> np.ndarray:
    """Decode one lane of len(freqs) symbols; no pull in the last k."""
    x = state
    pos = 0
    n = freqs.shape[0]
    out = []
    for i in range(n):
        slot = x & (SCALE - 1)
        s = int(np.sum(cdf_lows[i] <= slot)) - 1
        out.append(s)
        x = int(freqs[i, s]) * (x >> SCALE_BITS) + slot - int(cdf_lows[i, s])
        if x < RANS_L and i < n - k:
            w = words[pos] if pos < len(words) else 0
            pos += 1
            x = (x << WORD_BITS) | w
    return np.asarray(out, np.int32)


def encode_reverse(sym_sel_freq: np.ndarray, sym_sel_start: np.ndarray,
                   active: np.ndarray, x0: int = RANS_L, native: bool = True
                   ) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """Per-lane reverse encode of (T, M) selected tables: returns (per-lane
    word arrays in decode-read order, final states (M,) uint32, warmup
    counts k (M,) int32). ``native`` runs the g++-built runtime
    (coding/native/rans.cpp; raises when it cannot be built), else the numpy
    loop, its plain version: the same bytes."""
    if native:
        return _encode_reverse_native(sym_sel_freq, sym_sel_start, active, x0)
    T, M = sym_sel_freq.shape
    x = np.full(M, x0, np.uint64)
    k = np.zeros(M, np.int32)
    emitted: List[List[int]] = [[] for _ in range(M)]
    for t in range(T - 1, -1, -1):
        a = active[t]
        f = np.where(a, np.maximum(sym_sel_freq[t].astype(np.uint64), 1), 1)
        start = sym_sel_start[t].astype(np.uint64)
        k += (a & (x < RANS_L)).astype(np.int32)
        emit = a & (x >= (f << WORD_BITS))
        for j in np.nonzero(emit)[0]:
            emitted[j].append(int(x[j] & WORD_MASK))
        x = np.where(emit, x >> WORD_BITS, x)
        x = np.where(a, ((x // f) << SCALE_BITS) + (x % f) + start, x)
    return ([np.asarray(e[::-1], np.uint32) for e in emitted],
            x.astype(np.uint32), k)


def _encode_reverse_native(sym_sel_freq, sym_sel_start, active, x0):
    import ctypes
    from .native import build as native_build
    lib = native_build.load()
    T, M = sym_sel_freq.shape
    freqs = np.ascontiguousarray(sym_sel_freq, np.uint32)
    starts = np.ascontiguousarray(sym_sel_start, np.uint32)
    act = np.ascontiguousarray(active, np.uint8)
    out_words = np.zeros((M, T), np.uint16)
    out_lens = np.zeros((M,), np.uint32)
    out_states = np.zeros((M,), np.uint32)
    out_k = np.zeros((M,), np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.rans_encode_reverse(
        T, M, p(freqs, ctypes.c_uint32), p(starts, ctypes.c_uint32),
        p(act, ctypes.c_uint8), x0, p(out_words, ctypes.c_uint16),
        p(out_lens, ctypes.c_uint32), p(out_states, ctypes.c_uint32),
        p(out_k, ctypes.c_int32))
    streams = [out_words[j, :out_lens[j]].astype(np.uint32) for j in range(M)]
    return streams, out_states, out_k


# ---------------------------------------------------------------------------
# Per-lane twins: one stream per lane (no codec path calls them; the JAX
# package keeps them as the on-device forms of encode_reverse and
# scalar_decode)
# ---------------------------------------------------------------------------

def encode_reverse_scan(freq_sel: torch.Tensor, start_sel: torch.Tensor,
                        active: torch.Tensor):
    """Reverse per-lane encode in torch (the JAX package's
    encode_reverse_scan, a reversed lax.scan): freq_sel / start_sel (T, M)
    uint32 values, active (T, M) bool, on one device. Returns (words (M, T)
    int64 in emission order, counts (M,) int64, states (M,) int64 holding
    uint32 values); lane j's decode-order stream is words[j, :counts[j]]
    reversed. The bytes of encode_reverse at x0 = RANS_L."""
    T, M = freq_sel.shape
    dev = freq_sel.device
    f_all, s_all = freq_sel.long(), start_sel.long()
    states = torch.full((M,), RANS_L, dtype=torch.long, device=dev)
    wptr = torch.zeros(M, dtype=torch.long, device=dev)
    buf = torch.zeros(M, T, dtype=torch.long, device=dev)
    lane = torch.arange(M, device=dev)
    for t in range(T - 1, -1, -1):
        a = active[t]
        f = torch.clamp(f_all[t], min=1)
        emit = a & (states >= (f << WORD_BITS))
        buf[lane[emit], wptr[emit]] = states[emit] & WORD_MASK
        states = torch.where(emit, states >> WORD_BITS, states)
        xn = (((states // f) << SCALE_BITS) + (states % f) + s_all[t]) & MASK32
        states = torch.where(a, xn, states)
        wptr = wptr + emit.long()
    return buf, wptr, states


def decode_step(states: torch.Tensor, ptrs: torch.Tensor, streams: torch.Tensor,
                freq: torch.Tensor, cdf_low: torch.Tensor, active: torch.Tensor):
    """One per-lane rANS decode step over M lanes (the JAX package's
    decode_step): states (M,) uint32 values, ptrs (M,) read pointers into
    streams (M, W) words, freq / cdf_low (M, L) this step's tables, active
    (M,) bool. Returns (symbols (M,) int64, states (M,) int64, ptrs (M,)
    int64); an inactive lane keeps its state and pointer and returns 0."""
    states, ptrs = states.long(), ptrs.long()
    freq, cdf_low = freq.long(), cdf_low.long()
    slot = states & (SCALE - 1)
    sym = (cdf_low <= slot[:, None]).sum(-1) - 1
    f = torch.gather(freq, -1, sym[:, None])[:, 0]
    start = torch.gather(cdf_low, -1, sym[:, None])[:, 0]
    x = (f * (states >> SCALE_BITS) + slot - start) & MASK32
    need = x < RANS_L
    pos = torch.clamp(ptrs, 0, streams.shape[1] - 1)
    word = torch.gather(streams.long(), 1, pos[:, None])[:, 0]
    x = torch.where(need, ((x << WORD_BITS) | word) & MASK32, x)
    return (torch.where(active, sym, 0), torch.where(active, x, states),
            torch.where(active, ptrs + need.long(), ptrs))


# ---------------------------------------------------------------------------
# Interleaved variant, torch twins: R lanes, one shared word stream
# ---------------------------------------------------------------------------

def decode_step_interleaved(states, gptr, stream, freq, cdf_low, active,
                            cnt, thresh):
    """One rANS sub-iteration over R lanes for a batch of images
    (rans.decode_step_interleaved of the JAX package, at one chunk).

    states (B, R) int64 holding uint32 values; gptr (B,) int64 read pointer
    into stream (B, W) int64 words; freq/cdf_low (B, R, L) int64; active
    (B, R) bool; cnt/thresh (B, R) int64 (tail packing: no pull once a lane
    has decoded thresh symbols). Returns (symbols (B, R), states, gptr, cnt).
    """
    slot = states & (SCALE - 1)
    sym = (cdf_low <= slot[..., None]).sum(-1) - 1
    f = torch.gather(freq, -1, sym[..., None])[..., 0]
    start = torch.gather(cdf_low, -1, sym[..., None])[..., 0]
    x = (f * (states >> SCALE_BITS) + slot - start) & MASK32
    need = active & (x < RANS_L) & (cnt < thresh)
    cnt = cnt + active.long()
    ni = need.long()
    rank = torch.cumsum(ni, -1) - ni
    pos = torch.clamp(gptr[:, None] + rank, 0, stream.shape[1] - 1)
    w = torch.gather(stream, 1, pos)
    x = torch.where(need, ((x << WORD_BITS) | w) & MASK32, x)
    states = torch.where(active, x, states)
    gptr = gptr + ni.sum(-1)
    return torch.where(active, sym, 0), states, gptr, cnt


def encode_reverse_step_interleaved(states, gw, kwarm, freq, start, active,
                                    words, count_warmup: bool):
    """One reverse sub-iteration over R lanes for a batch of images: emit
    renorm words in DESCENDING lane rank at words[b, gw + total-1-rank]
    (the final reversal restores decode order), then absorb the symbol.
    states (B, R) int64; gw (B,) int64; freq/start (B, R) int64; active
    (B, R) bool; words (B, W) int64, written in place. Returns
    (states, gw, kwarm)."""
    f = torch.clamp(freq, min=1)
    if count_warmup:
        kwarm = kwarm + (active & (states < RANS_L)).long()
    emit = active & (states >= (f << WORD_BITS))
    ei = emit.long()
    total = ei.sum(-1)
    fwd = torch.cumsum(ei, -1) - ei
    cap = words.shape[1]
    pos = gw[:, None] + total[:, None] - 1 - fwd
    ok = emit & (pos < cap)
    bi, li = torch.nonzero(ok, as_tuple=True)
    words[bi, pos[bi, li]] = states[bi, li] & WORD_MASK
    states = torch.where(emit, states >> WORD_BITS, states)
    xn = ((states // f) << SCALE_BITS) + (states % f) + start
    states = torch.where(active, xn, states)
    return states, gw + total, kwarm


# ---------------------------------------------------------------------------
# Interleaved reverse encode over a (T, M) wavefront schedule
# ---------------------------------------------------------------------------

R_LANES = 64    # lanes of the scan codecs: a step's M positions split into
                # M / R_LANES sub-iterations, or one of M lanes when M < 64
                # (the rule of the JAX package's XLA scans; wavefront.py pads
                # M > 64 to a multiple of 64)


def lanes(M: int) -> int:
    """Persistent rANS lanes of a schedule with M positions a step."""
    return R_LANES if M >= R_LANES else M


def encode_reverse_scan_interleaved(freq_sel: torch.Tensor, start_sel: torch.Tensor,
                                    active: torch.Tensor, x0: int = RANS_L):
    """Reverse interleaved encode of a batch over (T, M) tables, matching
    decode_step_interleaved sub-iteration by sub-iteration (the JAX
    package's encode_reverse_scan_interleaved, vmapped over the batch).

    freq_sel / start_sel (B, T, M) int, active (T, M) bool, all on one
    device. Returns (words (B, T*M) int64 in emission order, n_words (B,),
    states (B, r) int64 holding uint32 values, k (B, r) warmup counts; 0
    for x0 = RANS_L); image b's decode-order stream is
    words[b, :n_words[b]] reversed."""
    B, T, m = freq_sel.shape
    r = lanes(m)
    dev = freq_sel.device
    states = torch.full((B, r), x0, dtype=torch.long, device=dev)
    gw = torch.zeros(B, dtype=torch.long, device=dev)
    kwarm = torch.zeros(B, r, dtype=torch.long, device=dev)
    words = torch.zeros(B, T * m, dtype=torch.long, device=dev)
    f_all, s_all = freq_sel.long(), start_sel.long()
    for t in range(T - 1, -1, -1):
        for si in range(m // r - 1, -1, -1):
            sl = slice(si * r, (si + 1) * r)
            states, gw, kwarm = encode_reverse_step_interleaved(
                states, gw, kwarm, f_all[:, t, sl], s_all[:, t, sl],
                active[t, sl].expand(B, r), words, count_warmup=True)
    return words, gw, states, kwarm
