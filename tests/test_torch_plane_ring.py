"""Kernel 5's ring path (csrc/plane_forward.cu) replayed on the CPU: the
schedule of one plane, phase by phase, against the ring slots of
planar_kernel.ring_geometry, the formula the kernel is given.

A step of the scan runs five phases, each ended by a barrier: level 1 (it
also puts the pad value back into the q ring's row of the step's diagonal),
level 2, level 3 (its skip reads level 1), level 4, the decode (warp 0 writes
each symbol's centre into the q ring). Level l's cell (h, w) is computed at
step BH h + w + CTR l from the taps of level l - 1. No card, no JAX.
"""

import numpy as np
import pytest

from imgcomp_cvpr_tpu_torch.coding import planar, planar_kernel as plk

K = 5
KF, L = 24, 6
PHASES = 8     # time of a phase: PHASES * step + phase
# The H100's opt-in limit a block (232,448 bytes) less the scan's static
# shared memory (the logits, R x MAX_L floats, and the 128-word window).
H100_ROOM = 232448 - 4 * (planar.R * plk.MAX_L + 128)

# The K = 5 latents of the tests and tools, the Kodak latent (512 x 768), a
# tall one whose rings wrap every 21 steps with few slots a row, one too wide
# for the rings (40 cells a level-0 diagonal) and a 1080p one.
SHAPES = [(4, 8, 8), (3, 5, 9), (2, 5, 9), (3, 12, 20), (3, 16, 24), (4, 16, 24),
          (32, 8, 12), (32, 64, 96), (2, 60, 24), (2, 24, 480), (32, 135, 240)]


def _cells(sched, level):
    Hl, Wl = sched.grids[level]
    h, w = np.meshgrid(np.arange(Hl), np.arange(Wl), indexing='ij')
    h, w = h.reshape(-1), w.reshape(-1)
    return h, w, sched.BH * h + w + sched.CTR * level


def _replay(sched, geom):
    """Per ring (levels 0-3): writes (slot, time, id) and reads (slot, time,
    the id of the write the read must find)."""
    BH, CTR = sched.BH, sched.CTR
    _, H, W = sched.latent_shape
    reach = planar.geometry(K)[1]
    H0, W0 = sched.grids[0]
    pad_id = H0 * W0            # refill ids: pad_id + step * slots + column
    writes = {j: [] for j in range(4)}
    reads = {j: [] for j in range(4)}

    def level0_id(h0, w0):
        inner = (h0 >= reach) & (h0 < H + reach) & (w0 >= reach) & (w0 < W + reach)
        u = BH * h0 + w0
        return np.where(inner, h0 * W0 + w0, pad_id + u * geom.slots + h0 % geom.slots)

    # The pad refill of every step's row, then the decode of the latent cells.
    t = np.arange(sched.T2)
    col = np.arange(geom.slots)
    tt, cc = np.meshgrid(t, col, indexing='ij')
    writes[0].append(((tt % geom.depth) * geom.slots + cc, PHASES * tt,
                      pad_id + tt * geom.slots + cc))
    h0, w0 = np.meshgrid(np.arange(H) + reach, np.arange(W) + reach, indexing='ij')
    h0, w0 = h0.reshape(-1), w0.reshape(-1)
    u = BH * h0 + w0
    writes[0].append((geom.slot(u, h0), PHASES * u + 4, h0 * W0 + w0))
    for l in range(1, 5):
        h, w, step = _cells(sched, l)
        when = PHASES * step + (l - 1)
        if l < 4:
            writes[l].append((geom.slot(step - CTR * l, h), when, h * sched.grids[l][1] + w))
        Ws = sched.grids[l - 1][1]
        for dy, dx in sched.taps[l - 1]:
            hs, ws = h + dy, w + dx
            want = level0_id(hs, ws) if l == 1 else hs * Ws + ws
            reads[l - 1].append((geom.slot(BH * hs + ws, hs), when, want))
        if l == 3:      # the skip: level-1 cell (h + K - 1, w + K - 1)
            hs, ws = h + K - 1, w + K - 1
            reads[1].append((geom.slot(BH * hs + ws, hs), when,
                             hs * sched.grids[1][1] + ws))
    cat = lambda parts: tuple(np.concatenate([np.ravel(a) for a in x]).astype(np.int64)
                              for x in zip(*parts))
    return {j: cat(writes[j]) for j in range(4)}, {j: cat(reads[j]) for j in range(4)}


@pytest.mark.parametrize('shape', SHAPES)
def test_ring_replay_every_read_finds_its_cell(shape):
    """Every tap and skip read of a phase finds, in its slot, the write of
    the cell it wants (the last write to the slot before the read's phase),
    and no write lands on a slot whose cell is still to be read."""
    sched = planar.build_planar_schedule(shape, K)
    geom = plk.ring_geometry(sched)
    assert geom.depth == sched.CTR + 1 == 21
    assert all(tp == tuple(divmod(k, K) for k in range(len(tp))) for tp in sched.taps)
    writes, reads = _replay(sched, geom)
    span = PHASES * (sched.T2 + 1)
    for j in range(4):
        slot, when, ids = writes[j]
        rslot, rwhen, want = reads[j]
        assert slot.min() >= 0 and max(slot.max(), rslot.max()) < geom.depth * geom.slots
        order = np.argsort(slot * span + when, kind='stable')
        slot, when, ids = slot[order], when[order], ids[order]
        key = slot * span + when
        assert np.all(np.diff(key) > 0), f'ring {j}: two writes to one slot in one phase'
        at = np.searchsorted(key, rslot * span + rwhen, side='left') - 1
        assert np.all(at >= 0), f'ring {j}: a read before any write to its slot'
        assert np.array_equal(slot[at], rslot), f'ring {j}: a read before its slot was written'
        bad = ids[at] != want
        assert not bad.any(), (f'ring {j}: {int(bad.sum())} of {bad.size} reads find another '
                               f'cell, first at time {int(rwhen[bad][0])}')
        last = np.full(int(ids.max()) + 1, -1, np.int64)
        np.maximum.at(last, want, rwhen)
        same = slot[1:] == slot[:-1]
        live = same & (last[ids[:-1]] >= when[1:])
        assert not live.any(), f'ring {j}: {int(live.sum())} writes over a cell still to be read'


@pytest.mark.parametrize('shape', SHAPES)
def test_ring_choice_matches_the_byte_count(shape):
    """The wrapper's choice (ring_fits at the H100's room) is the byte count
    of the weights and the four rings against that room, with a thread for
    every (cell, channel) of a band: the Kodak and the tall latent take the
    rings, the 1080p and the wide one the staged path."""
    sched = planar.build_planar_schedule(shape, K)
    geom = plk.ring_geometry(sched)
    n_params = sum(len(tp) * cin * cout for tp, cin, cout in
                   zip(sched.taps, (1, KF, KF, KF), (KF, KF, KF, L))) + 1 + L
    # Each cell of a diagonal has a slot, and a tap's rows below (K // 2) fit.
    assert geom.slots >= K // 2 + 1
    for l in range(5):
        h, w, _ = _cells(sched, l)
        most = np.bincount(sched.BH * h + w).max()
        assert plk.diagonal_cells(sched, l) == most
        assert l == 4 or geom.slots >= most
    floats = (-(-n_params // 4) * 4 + -(-geom.depth * geom.slots // 4) * 4
              + 3 * geom.depth * geom.slots * KF)
    assert plk.ring_bytes(geom, KF, n_params) == 4 * floats
    threads = plk.scan_threads(sched, KF)
    covered = all(plk.diagonal_cells(sched, l) * (L if l == 4 else KF) <= threads
                  for l in range(1, 5))
    fits = plk.ring_fits(sched, KF, L, n_params, H100_ROOM)
    assert fits == (covered and 4 * floats <= H100_ROOM)
    assert fits == (shape not in [(2, 24, 480), (32, 135, 240)])
    for force in (plk.FORCE_STAGED, 1, 2):
        assert not plk.ring_fits(sched, KF, L, n_params, H100_ROOM, force)
    assert not plk.ring_fits(sched, 8, L, n_params, H100_ROOM)
