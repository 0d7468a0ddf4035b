"""One client, closed loop, single images through the file codec.

The traffic file gives ``images`` (the image set: glob, count and sha256)
and optionally ``crop`` ([h, w], the top-left crop of every image). Each
request is one seeded pick of the set: ``CodecModel.compress`` of the
uint8 image (B=1, the .icz bytes held in memory), then ``decompress`` back
to uint8 pixels on the host; its latency is the host clock around both.
The next request starts when the last has returned. The window ends with
the request that is running when --seconds have passed.

The harness wraps the model's ``_enc`` / ``_dec`` and its codec's
``encode_batch`` / ``decode_batch`` on the instance, for the spans, for a
request's host time by part (printed as medians beside the result) and to
keep what the requests produced for the check; the program is not edited.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from perfbench import harness, models
from perfbench.judge import codec as judge_codec
from perfbench.roofline import counts

SAMPLE_SLOTS = 3     # requests kept by the seeded reservoir, besides the longest
MAX_REQUESTS = 65536
# A request's host time by part, printed as medians: the wrapped calls
# (the AE's at B=1 wait on their own launches, the codec's on the card)
# inside compress and decompress.
SPLIT = ('compress', 'ae_encode', 'codec_encode', 'decompress', 'codec_decode', 'ae_decode')


class Ctx(NamedTuple):
    cfg: Dict
    traffic: Dict
    seed: int
    device: torch.device
    tracer: harness.Tracer
    weights: models.Weights
    model: object              # imgcomp_cvpr_tpu_torch.tools.codec_cli.CodecModel
    images: np.ndarray         # (N, H, W, 3) uint8 on the host
    last: Dict                 # what the wrapped calls saw in the current request


def _wrap(obj, name, tracer, span, keep, last):
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        t = time.perf_counter()
        with tracer.span(span):
            out = fn(*args, **kwargs)
        last[span] = time.perf_counter() - t
        last[keep] = (args, out)
        return out
    setattr(obj, name, wrapped)


def setup(cfg: Dict, traffic: Dict, seed: int, device, tracer) -> Ctx:
    from imgcomp_cvpr_tpu_torch.tools import codec_cli
    weights = models.load_weights(cfg, device)
    prog = models.build_program(cfg, weights, device, cfg['serve']['ae_dtype'])
    model = codec_cli.CodecModel(prog.ae, prog.pc)
    images = harness.load_images(traffic['images'], 'cpu').numpy()
    if traffic.get('crop'):
        h, w = traffic['crop']
        images = np.ascontiguousarray(images[:, :h, :w])
    last: Dict = {}
    _wrap(model, '_enc', tracer, 'ae_encode', 'enc', last)
    _wrap(model, '_dec', tracer, 'ae_decode', 'dec', last)
    _wrap(model.codec, 'encode_batch', tracer, 'codec_encode', 'codec_enc', last)
    _wrap(model.codec, 'decode_batch', tracer, 'codec_decode', 'codec_dec', last)
    ctx = Ctx(cfg, traffic, seed, device, tracer, weights, model, images, last)
    warm = np.random.default_rng([seed, 1]).choice(images.shape[0], 2)
    for i in warm:           # the one shape of the window
        model.decompress(model.compress(images[i]))
    return ctx


def window(ctx: Ctx, seconds: float) -> harness.Window:
    sp, model, last = ctx.tracer.span, ctx.model, ctx.last
    picks = np.random.default_rng(ctx.seed).choice(ctx.images.shape[0], MAX_REQUESTS)
    keep = np.random.default_rng([ctx.seed, 2])
    kept, longest, lat, nbytes = [], [None, -1], [], 0
    split = {k: [] for k in SPLIT}
    with sp('window'):
        t0 = time.perf_counter()
        while True:
            i = int(picks[len(lat) % MAX_REQUESTS])
            t = time.perf_counter()
            with sp('compress'):
                blob = model.compress(ctx.images[i])
            last['compress'] = time.perf_counter() - t
            with sp('decompress'):
                out = model.decompress(blob)
            t_end = time.perf_counter()
            last['decompress'] = t_end - t - last['compress']
            lat.append(t_end - t)
            for k in SPLIT:
                split[k].append(last[k])
            nbytes += len(blob)
            req = (i, last['enc'][1], last['codec_enc'][1][0].theoretical_bits,
                   last['dec'][0][0], out)
            n = len(lat) - 1
            if len(blob) > longest[1]:
                longest[:] = [req, len(blob)]
            if n < SAMPLE_SLOTS:
                kept.append(req)
            else:
                j = int(keep.integers(0, n + 1))
                if j < SAMPLE_SLOTS:
                    kept[j] = req
            if t_end - t0 >= seconds:
                break
        t1 = time.perf_counter()
    if all(longest[0] is not r for r in kept):
        kept.append(longest[0])
    samples = [judge_codec.Sample(
        torch.from_numpy(ctx.images[i][None]), enc, dec,
        torch.tensor([theo], dtype=torch.float64), torch.from_numpy(out[None]))
        for i, enc, theo, dec, out in kept]
    ms = np.asarray(lat) * 1e3
    px = ctx.images.shape[1] * ctx.images.shape[2]
    e2e = {'file_roundtrip_ms_p95': float(np.percentile(ms, 95))}
    extra = {'file_roundtrip_ms_median': float(np.median(ms)), 'requests': len(lat),
             'file_bpp': nbytes * 8 / (px * len(lat)),
             'host_ms_median': {k: float(np.median(v)) * 1e3 for k, v in split.items()}}
    cnt = {'units': len(lat), 'requests': len(lat), 'attempted': len(lat), 'failed': 0}
    return harness.Window(t0, t1, cnt, e2e, samples, extra)


def work(ctx: Ctx, win: harness.Window) -> Dict:
    """Least device time of one request at the card's peaks (roofline/counts.py)."""
    h, w = ctx.images.shape[1:3]
    return counts.codec_work(ctx.cfg, h, w, 1, win.extra['file_bpp'] * h * w / 16)


def release(ctx: Ctx) -> None:
    ctx.model.codec._coders.clear()


numbers = judge_codec.run_numbers
control_numbers = judge_codec.run_control_numbers
