"""Closed-loop stream of image batches through the served batch path.

The traffic file gives ``batch`` (images a batch), ``images`` (the image
set: glob, count and sha256 of the files) and optionally ``crop`` ([h, w],
the top-left crop of every image). Every batch is a new seeded draw of
``batch`` distinct images of the set.

Each batch goes through a frozen copy of bench_torch.py's depth-2 pipeline
over the codec's submit / finish calls: AE encode and entropy-encode submit
of batch n+1 are enqueued before the host serializes batch n; its streams
are parsed and their decode submitted, and batch n-1's decode is finished
and AE-decoded. The window ends after the last batch started inside it is
decoded and the card has finished.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from perfbench import harness, models
from perfbench.judge import codec as judge_codec
from perfbench.roofline import counts

SAMPLE_SLOTS = 2     # batches kept by the seeded reservoir, besides the longest
MAX_BATCHES = 4096


class Ctx(NamedTuple):
    cfg: Dict
    traffic: Dict
    seed: int
    device: torch.device
    tracer: harness.Tracer
    weights: models.Weights
    prog: models.Program
    images: torch.Tensor       # (N, H, W, 3) uint8 on the device
    centers_dev: torch.Tensor


def setup(cfg: Dict, traffic: Dict, seed: int, device, tracer) -> Ctx:
    weights = models.load_weights(cfg, device)
    prog = models.build_program(cfg, weights, device, cfg['serve']['ae_dtype'])
    images = harness.load_images(traffic['images'], device)
    if traffic.get('crop'):
        h, w = traffic['crop']
        images = images[:, :h, :w].contiguous()
    centers_dev = torch.as_tensor(prog.centers, dtype=torch.float32, device=device)
    ctx = Ctx(cfg, traffic, seed, device, tracer, weights, prog, images, centers_dev)
    warm = draws(ctx, np.random.default_rng([seed, 1]), 2)
    for i in range(2):       # every shape of the window, and the codec's stream-word guess
        idx = warm[i % warm.shape[0]]
        syms = ae_encode_syms(prog.ae, images[idx].float())
        rs = prog.codec.encode_batch(syms, prog.centers)
        dec = prog.codec.decode_batch([r.bitstream for r in rs], prog.centers, device_out=True)
        ae_decode_syms(prog.ae, centers_dev, dec)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return ctx


def draws(ctx: Ctx, rng, rows: int = MAX_BATCHES):
    """(rows, batch) image indices on the device, uploaded at once so that a
    batch's fetch waits for nothing: each row a new draw without
    replacement. A window longer than ``rows`` batches starts over."""
    n, b = ctx.images.shape[0], ctx.traffic['batch']
    idx = np.stack([rng.choice(n, b, replace=b > n) for _ in range(rows)])
    return torch.as_tensor(idx, device=ctx.device)


def ae_encode_syms(ae, x):
    """(B, H, W, 3) images -> (B, C, H', W') int32 symbols on x's device."""
    return ae.encode(x).symbols.permute(0, 3, 1, 2).contiguous()


def ae_decode_syms(ae, centers_dev, syms):
    """(B, C, H', W') symbols -> centers -> AE decode, (B, H, W, 3) f32."""
    return ae.decode(centers_dev[syms.long()].permute(0, 2, 3, 1))


class Batch:
    __slots__ = ('idx', 'syms', 'handle', 'results', 'dec', 'x_out')


def window(ctx: Ctx, seconds: float) -> harness.Window:
    prog, sp = ctx.prog, ctx.tracer.span
    codec, ae, centers = prog.codec, prog.ae, prog.centers
    table = draws(ctx, np.random.default_rng(ctx.seed))
    pick = np.random.default_rng([ctx.seed, 2])
    kept: List[Batch] = []
    longest = [None, -1]
    done = {'started': 0, 'batches': 0, 'pixels': 0, 'bits': 0}

    def start():
        b = Batch()
        with sp('fetch'):
            b.idx = table[done['started'] % table.shape[0]]
            done['started'] += 1
            x = ctx.images[b.idx].float()
        with sp('ae_encode'):
            b.syms = ae_encode_syms(ae, x)
        with sp('codec_encode_submit'):
            b.handle = codec.encode_batch_submit(b.syms, centers)
        return b

    def finish_decode(b: Batch):
        with sp('codec_decode_finish'):
            b.dec = codec.decode_batch_finish(b.handle, device_out=True)
        with sp('ae_decode'):
            b.x_out = ae_decode_syms(ae, ctx.centers_dev, b.dec)
        n = done['batches']
        bits = sum(r.num_bits for r in b.results)
        done['batches'] += 1
        done['pixels'] += int(np.prod(b.x_out.shape[:3]))
        done['bits'] += bits
        if bits > longest[1]:
            longest[:] = [b, bits]
        if n < SAMPLE_SLOTS:
            kept.append(b)
        else:
            j = int(pick.integers(0, n + 1))
            if j < SAMPLE_SLOTS:
                kept[j] = b
        b.handle = None

    with sp('window'):
        t0 = time.perf_counter()
        cur, prev = start(), None
        while True:
            more = time.perf_counter() - t0 < seconds
            nxt = start() if more else None
            with sp('codec_encode_finish'):
                cur.results = codec.encode_batch_finish(cur.handle)
            with sp('codec_decode_submit'):
                cur.handle = codec.decode_batch_submit([r.bitstream for r in cur.results], centers)
            if prev is not None:
                finish_decode(prev)
            if not more:
                break
            prev, cur = cur, nxt
        finish_decode(cur)
        if ctx.device.type == 'cuda':
            torch.cuda.synchronize(ctx.device)
        t1 = time.perf_counter()
    if longest[0] not in kept:
        kept.append(longest[0])
    samples = [judge_codec.Sample(
        ctx.images[b.idx], b.syms, b.dec,
        torch.tensor([r.theoretical_bits for r in b.results], dtype=torch.float64),
        b.x_out) for b in kept]
    wall = t1 - t0
    e2e = {'codec_mp_per_s': done['pixels'] / 1e6 / wall,
           'stream_bpp': done['bits'] / done['pixels']}
    cnt = {'units': done['batches'], 'batches': done['batches'],
           'images': done['batches'] * ctx.traffic['batch'], 'bits': done['bits'],
           'attempted': done['batches'] * ctx.traffic['batch'], 'failed': 0}
    return harness.Window(t0, t1, cnt, e2e, samples, {})


def work(ctx: Ctx, win: harness.Window) -> Dict:
    """Least device time of one batch at the card's peaks (roofline/counts.py)."""
    h, w = ctx.images.shape[1:3]
    words = win.counts['bits'] / 16 / max(win.counts['batches'], 1)
    return counts.codec_work(ctx.cfg, h, w, ctx.traffic['batch'], words)


def release(ctx: Ctx) -> None:
    """Drop the program's modules and coders (the window's samples stay)."""
    ctx.prog.codec._coders.clear()


numbers = judge_codec.run_numbers
control_numbers = judge_codec.run_control_numbers
