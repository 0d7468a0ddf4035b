"""Interleaved rANS primitives (port of imgcomp_cvpr_tpu/coding/rans.py).

- state: uint32 in [2^16, 2^32) (below 2^16 only during an x0=1 warmup);
  16-bit renormalization words;
- per-symbol frequency tables sum to SCALE = 2^16;
- encode runs in reverse symbol order, decode forward.

``decode_step_interleaved`` and ``encode_reverse_step_interleaved`` are one
R-lane sub-iteration of the plain versions of kernels 2 and 5 (decode) and
3 and 6 (reverse encode). torch has thin uint32 support, so they keep
states in int64 and mask to 32 bits where the uint32 arithmetic would wrap.
"""

from __future__ import annotations

from typing import Tuple

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
# Interleaved sub-iterations: R lanes, one shared word stream
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
