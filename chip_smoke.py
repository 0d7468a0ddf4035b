#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Usage: ``python3 chip_smoke.py`` from the repository root (needs one CUDA
card and nvcc; exits non-zero without them).

Phases, one line each:
  1. the device (torch name, nvidia-smi name and power limit);
  2. the build of every kernel in imgcomp_cvpr_tpu_torch/csrc (nvcc,
     sm_90a, one process per source, in parallel);
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes (B=16 Kodak-size images, latent (32, 64, 96));
     The planar kernels 5 and 6 (context model ``pc base``: K=5, kf=24,
     seeded weights) run over the whole volume; kernel 5 is held against
     its plain version on one plane (plane 2, whose bias rows come from two
     coded planes): the plain version's Python loop over 824 steps would
     not fit the time limit for all 32 planes;
  4. the K=3 main path: B=16 natural-statistics 512x768 images with the
     trained model (assets/demo_trained_low_9000.npz): AE encode ->
     kernel 2 encode -> kernel 3 -> container serialize -> parse -> kernel 2
     decode -> AE decode, CRC-verified bit-exact, with per-leg times;
  5. the K=5 main path: the same images through the trained AE and the
     seeded K=5 context model: AE encode -> per plane bias rows + kernel 5
     encode -> kernel 6 -> container (impl id 6) -> parse -> per plane
     kernel 5 decode -> device CRC -> AE decode, bit-exact, with leg times;
  6. the kernels line: each kernel's launches in its main-path phase (4 or
     5), its error against the plain version, times and bound.
The last line is {"ok": true, "device": {...}}. Any failed check raises,
which exits non-zero before that line is printed.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'assets',
                     'demo_trained_low_9000.npz')
BATCH, IMG_H, IMG_W = 16, 512, 768


def natural_images(rng, b, h, w):
    """1/f^2-spectrum RGB images (the power spectrum of natural scenes)
    with a shared luminance field; own copy of bench.py's generator."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = 1.0 / f

    def pink():
        spec = amp * np.exp(2j * np.pi * rng.rand(h, w))
        x = np.real(np.fft.ifft2(spec))
        lo, hi = x.min(), x.max()
        return (x - lo) / (hi - lo + 1e-9)

    out = np.empty((b, h, w, 3), np.float32)
    for i in range(b):
        base = pink()
        for c in range(3):
            out[i, :, :, c] = np.clip(0.8 * base + 0.2 * pink(), 0, 1) * 255
    return out


def cuda_ms(fn, reps=1):
    """Mean ms of fn() over reps launches, timed with CUDA events after
    one warm-up call."""
    import torch
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    """ms of one fn() call on the host clock, synchronised (for the plain
    versions, whose Python loops take seconds)."""
    import torch
    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return (time.time() - t) * 1e3, out


def planar_kernels(dev, syms, centers, pc5, pc5_config, rows):
    """Phase 3 for kernels 5 and 6 at the main path's shapes (B=16, latent
    (32, 64, 96), K=5). Kernel 5 runs every plane; it is held against its
    plain version on plane P = 2 in both modes. Adds rows to ``rows``."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import planar, planar_codec
    from imgcomp_cvpr_tpu_torch.coding import planar_kernel as plk
    P = 2
    B, C, H, W = syms.shape
    shape = (C, H, W)
    coder = planar_codec.PlanarCoder(pc5, pc5_config, device=dev)
    sched, fold = coder._prepare(shape, centers)
    K, kf, L = coder.K, fold.top.w1.shape[-1], coder.L
    syms = syms.int().contiguous()

    # Encode every plane through kernel 5; keep plane P's inputs.
    hist = coder._history(fold, sched, B)
    fsel = torch.empty(B, C, sched.T2, planar.R, dtype=torch.int32, device=dev)
    ssel = torch.empty_like(fsel)
    for d in range(C):
        bias = coder.bias_rows(fold, hist)
        out = plk.plane_forward(plk.MODE_ENCODE, fold.top, shape, K, bias,
                                true_plane=syms[:, d].contiguous())
        if d == P:
            bias_p, out_p = bias, out
        fsel[:, d], ssel[:, d] = out.fsel, out.ssel
        coder._push(hist, out)
    true_p = syms[:, P].contiguous()
    plain_ms, op = host_ms(lambda: plk.plane_forward_plain(
        plk.MODE_ENCODE, fold.top, shape, K, bias_p, true_plane=true_p))
    act = torch.from_numpy(sched.idx_cm < H * W).to(dev)
    flips = int((((out_p.fsel != op.fsel) | (out_p.ssel != op.ssel)) & act).sum().item())
    entries = int(act.sum().item()) * B
    if flips > 1e-3 * entries:
        raise AssertionError(f'plane forward encode: {flips} flips > 0.1% of {entries}')
    act_err = max((a - b).abs().max().item()
                  for a, b in zip(out_p.acts + (out_p.q,), op.acts + (op.q,)))
    if act_err > 1e-5:
        raise AssertionError(f'plane forward encode: activations max abs err {act_err}')
    # Per launch (one plane of B images): top-slice tap products of every
    # level cell; bias rows and true symbols read, activations, q plane and
    # (freq, start) tables written.
    cells = [g[0] * g[1] for g in sched.grids]
    flops = 2 * B * sum(cells[l + 1] * len(sched.taps[l]) * (1 if l == 0 else kf)
                        * (L if l == 3 else kf) for l in range(4))
    io = 4 * B * (sum(cells[1:4]) * kf * 2 + cells[4] * L + cells[0])
    enc_bytes = io + 4 * B * (H * W + 2 * sched.T2 * planar.R)
    rows['plane_forward_encode'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/plane_forward.cu',
        replaces='imgcomp_cvpr_tpu/coding/planar_kernel.py:393',
        max_abs_err=act_err,
        ms=cuda_ms(lambda: plk.plane_forward(plk.MODE_ENCODE, fold.top, shape, K,
                                             bias_p, true_plane=true_p), 3),
        plain_ms=plain_ms, bound=bound(enc_bytes, flops), library_ms=None)
    print(f'[3 plane forward encode] K=5 latent {shape}: all {C} planes through '
          f'kernel 5; plane {P} vs plain (cut: one plane, the plain loop takes '
          f'{plain_ms / 1e3:.1f} s a plane): {flips} boundary flips of {entries} '
          f'active entries (tol 0.1%), activations max abs err {act_err:.3g}',
          flush=True)

    fsel = fsel.reshape(B, -1, planar.R)
    ssel = ssel.reshape(B, -1, planar.R)
    x0 = 1
    w_k, n_k, st_k, k_k = plk.plane_reverse(fsel, ssel, shape, K, x0)
    rev_plain_ms, (w_p, n_p, st_p, k_p) = host_ms(
        lambda: plk.plane_reverse_plain(fsel, ssel, shape, K, x0))
    if not (torch.equal(n_k, n_p) and torch.equal(st_k, st_p) and torch.equal(k_k, k_p)
            and all(torch.equal(w_k[i, :n_k[i]], w_p[i, :n_p[i]]) for i in range(B))):
        raise AssertionError('plane_reverse: output differs from the plain version')
    nw = int(n_k.sum().item())
    rows['plane_reverse'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/rans_reverse.cu',
        replaces='imgcomp_cvpr_tpu/coding/planar_kernel.py:540',
        max_abs_err=float(max((w_k[i, :n_k[i]] - w_p[i, :n_p[i]]).abs().max().item()
                              for i in range(B) if n_k[i] > 0)),
        ms=cuda_ms(lambda: plk.plane_reverse(fsel, ssel, shape, K, x0), 3),
        plain_ms=rev_plain_ms,
        bound=bound(2 * 4 * fsel.numel() + 4 * nw + 8 * planar.R * B, 0),
        library_ms=None)
    print(f'[3 plane_reverse] words/n_words/states/k byte-identical to the plain '
          f'version over {C} x {sched.T2} rows ({nw} words)', flush=True)

    # Decode every plane through kernel 5 from kernel 6's streams.
    streams = torch.zeros(B, sched.stream_cap, dtype=torch.int32, device=dev)
    for i in range(B):
        streams[i, :n_k[i]] = w_k[i, :n_k[i]].flip(0)
    thresh = (torch.from_numpy(coder.lane_totals(shape)).to(dev)[None] - k_k).int()
    plane_tot = torch.from_numpy(planar.plane_totals(sched)).to(dev)
    states, gptr = st_k, torch.zeros(B, dtype=torch.int32, device=dev)
    hist = coder._history(fold, sched, B)
    dec = torch.empty_like(syms)
    for d in range(C):
        bias = coder.bias_rows(fold, hist)
        args = dict(streams=streams, states=states, gptr=gptr,
                    thresh=(thresh - d * plane_tot).int().contiguous())
        out = plk.plane_forward(plk.MODE_DECODE, fold.top, shape, K, bias, **args)
        if d == P:
            bias_d, args_p, out_d = bias, args, out
        dec[:, d], states, gptr = out.syms, out.states, out.gptr
        coder._push(hist, out)
    if not torch.equal(dec, syms):
        raise AssertionError('plane forward decode: kernel did not recover the symbols')
    dplain_ms, dp = host_ms(lambda: plk.plane_forward_plain(
        plk.MODE_DECODE, fold.top, shape, K, bias_d, **args_p))
    if not (torch.equal(dp.syms, true_p) and torch.equal(dp.states, out_d.states)
            and torch.equal(dp.gptr, out_d.gptr)):
        raise AssertionError('plane forward decode: plain version differs on plane 2')
    words_p = 4 * int((out_d.gptr - args_p['gptr']).sum().item())
    rows['plane_forward_decode'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/plane_forward.cu',
        replaces='imgcomp_cvpr_tpu/coding/planar_kernel.py:393',
        max_abs_err=float((out_d.syms - true_p).abs().max().item()),
        ms=cuda_ms(lambda: plk.plane_forward(plk.MODE_DECODE, fold.top, shape, K,
                                             bias_d, **args_p), 3),
        plain_ms=dplain_ms,
        bound=bound(io + 4 * B * H * W + words_p + 16 * B * planar.R, flops),
        library_ms=None)
    print(f'[3 plane forward decode] kernel 5 recovers all {C} planes from kernel '
          f'6\'s streams (tail-packed, per-plane thresholds); the plain version '
          f'decodes plane {P} from the same state to the same symbols, state and '
          f'read pointer', flush=True)


def bound(nbytes, flops):
    t_b, t_f = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return (t_b, 'bytes') if t_b >= t_f else (t_f, 'operations')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card (torch.cuda.is_available() is False)',
              file=sys.stderr)
        return 2
    from imgcomp_cvpr_tpu_torch import weights as weights_lib
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib
    from imgcomp_cvpr_tpu_torch.coding import cuda_codec, cuda_kernel as ck
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
    from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build, quantize as qk
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib

    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f'[1 device] torch: {kind}; nvidia-smi: {smi}; torch {torch.__version__} '
          f'cuda {torch.version.cuda}', flush=True)

    t0 = time.time()
    logs = build.build_all()
    regs = '; '.join(f'{k}: ' + ' | '.join(l.strip() for l in v.splitlines()
                                           if 'registers' in l)
                     for k, v in logs.items())
    print(f'[2 build] {len(build.SOURCES)} kernels for sm_90a in '
          f'{time.time() - t0:.1f} s ({regs})', flush=True)

    ae_config, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc_config, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    ae = ae_lib.CVPRAutoencoder(ae_config, device=dev)
    pc = pc_lib.ProbClassifier(pc_config, ae_config.num_centers, device=dev)
    ae, pc = weights_lib.load_trained(ASSET, ae, pc, device=dev)
    centers = ae.encoder.centers.detach()
    lc = codec_lib.LatentCodec(pc, pc_config, device=dev)
    x_np = natural_images(np.random.RandomState(0), BATCH, IMG_H, IMG_W)
    x = torch.from_numpy(x_np).to(dev)

    # ---- phase 3: kernels against their plain versions -------------------
    with torch.no_grad():
        enc = ae.encode(x)
    syms = enc.symbols.permute(0, 3, 1, 2).contiguous()          # (B, C, H, W)
    shape = tuple(syms.shape[1:])
    n = int(np.prod(shape))
    sched = ck.build_schedule(shape)
    fw = cuda_codec.fold_weights(pc, centers)
    syms_flat = syms.reshape(BATCH, n).int().contiguous()
    rows = {}

    z = enc.z.contiguous()
    qs_k, qh_k, sym_k = qk.quantize_fwd(z, centers)
    qs_p, qh_p, sym_p = qk.quantize_plain(z, centers)
    if not torch.equal(sym_k, sym_p) or not torch.equal(qh_k, qh_p):
        raise AssertionError('quantize: symbols differ from the plain version')
    q_err = (qs_k - qs_p).abs().max().item()
    if q_err > 1e-5:
        raise AssertionError(f'quantize: qsoft max abs err {q_err}')
    nz = z.numel()
    rows['quantize'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/quantize.cu',
        replaces='imgcomp_cvpr_tpu/ops/pallas/quantize.py:147',
        max_abs_err=q_err, ms=cuda_ms(lambda: qk.quantize_fwd(z, centers), 20),
        plain_ms=cuda_ms(lambda: qk.quantize_plain(z, centers), 5),
        bound=bound(16 * nz, 9 * 6 * nz), library_ms=None)
    print(f'[3 quantize] z {tuple(z.shape)}: symbols equal, qsoft max abs err '
          f'{q_err:.3g} (tol 1e-5)', flush=True)

    macs = 0
    for li, layer in enumerate(sched.layers):
        cin = 1 if li == 0 else fw.w2.shape[1]
        cout = fw.w4.shape[-1] if li == 3 else fw.w2.shape[-1]
        macs += layer.taps.shape[0] * layer.taps.shape[1] * cin * cout
    fwd_flops = 2 * macs * BATCH
    act = torch.from_numpy(sched.idx_cm < n).to(dev)
    f_k, s_k = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=syms_flat)
    enc_plain_ms, (f_p, s_p) = host_ms(lambda: ck.wavefront_forward_plain(
        ck.MODE_ENCODE, fw, shape, true_syms=syms_flat))
    flips = int((((f_k != f_p) | (s_k != s_p)) & act).sum().item())
    entries = int(act.sum().item()) * BATCH
    if flips > 1e-3 * entries:
        raise AssertionError(f'forward encode: {flips} flips > 0.1% of {entries}')
    table_bytes = 2 * 4 * BATCH * sched.T * sched.CQ
    rows['wavefront_forward_encode'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/wavefront_forward.cu',
        replaces='imgcomp_cvpr_tpu/coding/pallas_kernel.py:1089',
        max_abs_err=float(((f_k - f_p).abs() * act).max().item()),
        ms=cuda_ms(lambda: ck.wavefront_forward(ck.MODE_ENCODE, fw, shape,
                                                true_syms=syms_flat)),
        plain_ms=enc_plain_ms,
        bound=bound(4 * BATCH * n + table_bytes, fwd_flops), library_ms=None)
    print(f'[3 forward encode] tables: {flips} boundary flips of {entries} active '
          f'entries (tol 0.1%)', flush=True)

    x0 = 1
    w_k, n_k, st_k, k_k = ck.rans_reverse(f_k, s_k, shape, x0)
    w_p, n_p, st_p, k_p = ck.rans_reverse_plain(f_k, s_k, shape, x0)
    if not (torch.equal(n_k, n_p) and torch.equal(st_k, st_p) and torch.equal(k_k, k_p)
            and all(torch.equal(w_k[i, :n_k[i]], w_p[i, :n_p[i]]) for i in range(BATCH))):
        raise AssertionError('rans_reverse: output differs from the plain version')
    rev_plain_ms, _ = host_ms(lambda: ck.rans_reverse_plain(f_k, s_k, shape, x0))
    rows['rans_reverse'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/rans_reverse.cu',
        replaces='imgcomp_cvpr_tpu/coding/pallas_kernel.py:1362',
        max_abs_err=float(max((w_k[i, :n_k[i]] - w_p[i, :n_p[i]]).abs().max().item()
                              for i in range(BATCH) if n_k[i] > 0)),
        ms=cuda_ms(lambda: ck.rans_reverse(f_k, s_k, shape, x0), 3),
        plain_ms=rev_plain_ms,
        bound=bound(table_bytes + 4 * int(n_k.sum().item()) + 8 * 32 * BATCH, 0),
        library_ms=None)
    print(f'[3 rans_reverse] words/n_words/states/k byte-identical to the plain '
          f'version ({int(n_k.sum().item())} words)', flush=True)

    thresh = (torch.from_numpy(ck.lane_totals(sched)).to(dev)[None] - k_k).int().contiguous()
    streams = torch.zeros(BATCH, sched.stream_cap, dtype=torch.int32, device=dev)
    for i in range(BATCH):
        streams[i, :n_k[i]] = w_k[i, :n_k[i]].flip(0)
    dec_k = ck.wavefront_forward(ck.MODE_DECODE, fw, shape, streams=streams,
                                 init_states=st_k, thresh=thresh)
    if not torch.equal(dec_k, syms_flat):
        raise AssertionError('forward decode: kernel did not recover the symbols')
    # The plain decoder decodes the plain encoder's streams (its own floats).
    wp2, np2, stp2, kp2 = ck.rans_reverse_plain(f_p, s_p, shape, x0)
    streams_p = torch.zeros_like(streams)
    for i in range(BATCH):
        streams_p[i, :np2[i]] = wp2[i, :np2[i]].flip(0)
    thresh_p = (torch.from_numpy(ck.lane_totals(sched)).to(dev)[None] - kp2).int()
    dec_plain_ms, dec_p = host_ms(lambda: ck.wavefront_forward_plain(
        ck.MODE_DECODE, fw, shape, streams=streams_p, init_states=stp2, thresh=thresh_p))
    if not torch.equal(dec_p, syms_flat):
        raise AssertionError('forward decode: plain version did not recover the symbols')
    rows['wavefront_forward_decode'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/wavefront_forward.cu',
        replaces='imgcomp_cvpr_tpu/coding/pallas_kernel.py:1089',
        max_abs_err=float((dec_k - syms_flat).abs().max().item()),
        ms=cuda_ms(lambda: ck.wavefront_forward(ck.MODE_DECODE, fw, shape,
                                                streams=streams, init_states=st_k,
                                                thresh=thresh)),
        plain_ms=dec_plain_ms,
        bound=bound(4 * int(n_k.sum().item()) + 4 * BATCH * n, fwd_flops),
        library_ms=None)
    print('[3 forward decode] kernel and plain version each recover the teacher '
          'symbols exactly from their own streams', flush=True)

    pc5_config, _ = config_lib.parse_spec('base', 'pc')
    pc5 = pc_lib.init_params(pc_lib.ProbClassifier(pc5_config, ae_config.num_centers,
                                                   device=dev), seed=0)
    lc5 = codec_lib.LatentCodec(pc5, pc5_config, device=dev)
    planar_kernels(dev, syms, centers, pc5, pc5_config, rows)

    # ---- phases 4 and 5: the main paths through the entry points ---------
    launches = {}
    for phase, codec in ((4, lc), (5, lc5)):
        torch.cuda.synchronize()
        build.reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        wall = time.time()
        ev[0].record()
        with torch.no_grad():
            enc = ae.encode(x)
            syms = enc.symbols.permute(0, 3, 1, 2).contiguous()
        ev[1].record()
        results = codec.encode_batch(syms, centers)
        ev[2].record()
        decoded = codec.decode_batch([r.bitstream for r in results], centers, verify=True)
        ev[3].record()
        with torch.no_grad():
            x_rec = ae.decode(centers[decoded.long()].permute(0, 2, 3, 1))
        ev[4].record()
        torch.cuda.synchronize()
        wall = time.time() - wall
        launches[phase] = dict(build.LAUNCHES)
        if not torch.equal(decoded.long(), syms.long()):
            raise AssertionError(f'main path {phase}: decoded symbols differ')
        if tuple(x_rec.shape) != (BATCH, IMG_H, IMG_W, 3) or not torch.isfinite(x_rec).all():
            raise AssertionError(f'main path {phase}: bad reconstruction {tuple(x_rec.shape)}')
        impl = {codec_lib.stream_impl_id(r.bitstream) for r in results}
        if impl != {codec.impl_id}:
            raise AssertionError(f'main path {phase}: impl ids {impl}')
        mse = torch.mean((x_rec - x) ** 2).item()
        psnr = 10 * np.log10(255.0 ** 2 / mse)
        if not psnr > 15.0:
            raise AssertionError(f'main path {phase}: reconstruction PSNR {psnr:.2f} dB')
        bits = sum(r.num_bits for r in results)
        theo = sum(r.theoretical_bits for r in results)
        legs = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
        # Tail packing (x0 = 1): a lane's last k symbols in decode order cost
        # no stream words; runs of symbol 0 (start 0) there are free, so a
        # model that predicts them badly can code below its own theory.
        ks = [codec_lib.deserialize_stream(r.bitstream)[4] for r in results]
        warm = np.mean([0 if k is None else int(k.sum()) for k in ks])
        mp = BATCH * IMG_H * IMG_W / 1e6
        model = ('K=3 trained pc cvpr/res_shallow' if phase == 4
                 else 'K=5 seeded pc base, impl id 6')
        print(f'[{phase} main path] {model}, B={BATCH} {IMG_H}x{IMG_W} latent {shape}: '
              f'CRC-verified bit-exact round-trip; bpp {bits / (BATCH * IMG_H * IMG_W):.5f}, '
              f'real/theory overhead {100 * (bits / theo - 1):.4f}% (tail-packed warmup '
              f'{warm:.1f} symbols/image), PSNR {psnr:.3f} dB; '
              f'ms: ae_encode {legs[0]:.3f}, entropy_encode {legs[1]:.3f}, '
              f'entropy_decode {legs[2]:.3f}, ae_decode {legs[3]:.3f}; '
              f'wall {wall * 1e3:.1f} ms = {mp / wall:.4f} MP/s enc+dec', flush=True)

    kernels = []
    for phase, name in ((4, 'quantize'), (4, 'wavefront_forward_encode'),
                        (4, 'wavefront_forward_decode'), (4, 'rans_reverse'),
                        (5, 'plane_forward_encode'), (5, 'plane_forward_decode'),
                        (5, 'plane_reverse')):
        n_launch = launches[phase][name]
        if n_launch < 1 or (name == 'quantize' and launches[5][name] < 1):
            raise AssertionError(f'kernel {name} was not launched on main path {phase}')
        r = rows[name]
        b_ms, b_by = r.pop('bound')
        kernels.append(dict(name=name, route=r['route'], source=r['source'],
                            replaces=r['replaces'], launches=n_launch,
                            max_abs_err=r['max_abs_err'], ms=r['ms'],
                            plain_ms=r['plain_ms'], bound_ms=b_ms, bound_by=b_by,
                            library_ms=r['library_ms']))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                            'count': torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
