#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Usage: ``python3 chip_smoke.py`` from the repository root (needs one CUDA
card and nvcc; exits non-zero without them). ``python3 chip_smoke.py
--quantizer-only [--root DIR]`` runs only kernels 1 and 7 on seeded inputs of
the main path's shapes, held to their plain versions and timed as in the
kernels line, with the package of DIR (a checkout of another commit) when
given: two such runs in one call compare two versions on one card.
``--kernel2-only [--root DIR] [--profile]`` does the same for kernel 2 (3a,
3b) at each operand precision the package has, on the trained K=3 context
model, after timing the main path's entropy legs at each precision twice,
and then kernel 5 (5a, 5b) with phase 5's seeded K=5 model; it prints
ptxas's registers and spills of each kernel-2 and kernel-5 instance.

Phases, one line each:
  1. the device (torch name, nvidia-smi name and power limit);
  2. the build of every kernel in imgcomp_cvpr_tpu_torch/csrc (nvcc,
     sm_90a, one process per source, in parallel);
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes (B=16 Kodak-size images, latent (32, 64, 96); the
     quantizer backward, kernel 7, at the training latent (30, 20, 20, 32);
     the quantizer forward, kernel 1, at both: the codec's z here and the
     training forward's own z in phase 6a);
     The planar kernels 5 and 6 (context model ``pc base``: K=5, kf=24,
     seeded weights) run over the whole volume; kernel 5's layer-parallel
     encode is held against its plain version and against its own
     teacher-forced scan on all 32 planes, its scan against the scan's
     plain version on one plane (plane 2, whose bias rows come from two
     coded planes: that Python loop over 824 steps takes ~20 s a plane),
     the scan's ring path (the default here) timed and profiled beside its
     staged path (FORCE_STAGED) on that plane.
     The bias-row kernel (csrc/bias_rows.cu) on the activations of that
     encode: its encode layout (4 launches) and decode layout (32) equal
     bit for bit, B = 1 equal to B = 16, the generic instance equal to the
     compile-time one, the kernel within 2e-5 of its plain version, timed
     beside its bound (also alone: ``--bias-rows-only``).
     Kernel 2's layer-parallel encode likewise equals its scan on every
     entry; decode is timed with the image over clusters of 8 and of 1
     blocks; both codecs decode B = 1, 3 and 17 images and write the same
     streams at B = 3 as at B = 1. Kernels 3 and 6 (the reverse encoder)
     are byte-identical to their plain versions at B=16, give the first
     three images the same outputs at B = 3 and B = 1, and print their clock
     profile (clocks a non-empty sub-iteration and those in its state
     update, the shares spent waiting) beside their chain floor;
  4. the K=3 main path: B=16 natural-statistics 512x768 images with the
     trained model (assets/demo_trained_low_9000.npz): AE encode ->
     kernel 2 encode (layer-parallel) -> kernel 3 -> container serialize -> parse -> kernel 2
     decode -> AE decode, CRC-verified bit-exact, with per-leg times;
  5. the K=5 main path: the same images through the trained AE and the
     seeded K=5 context model: AE encode -> per level bias rows + kernel 5
     encode (5 launches) -> kernel 6 -> container (impl id 6) -> parse -> per plane
     kernel 5 decode -> device CRC -> AE decode, bit-exact, with leg times;
  4c. the serving path of bench_torch.py: its depth-2 pipelined loop over
     the codec's submit / finish (decode with device_out) at B=16 with the
     trained K=3 model, f32 and then bf16 towers; submit / finish streams
     (also with two handles outstanding) byte-equal to a straight pass
     through the kernel wrappers for K=3 (B=16) and K=5 (B=3); the submits
     under torch.cuda.set_sync_debug_mode('error') (no wait for the card);
     the bf16 round trip CRC-verified, its symbols' agreement with the f32
     towers' (>= 99%) and both PSNRs; one-image roundtrip and decode;
  4d. the AE's fused eval-mode conv epilogue (csrc/ae_epilogue.cu) on the
     main path's own conv outputs: phase 4's path with the trained towers
     in bf16 (the serving towers) at B=16 and B=1 and in f32 at B=16, every
     one of the 70 epilogue calls of a round trip (packed and transposed-
     conv crop views, 0-2 residuals, C = 3, 33, 64 and 128) held bit for bit
     against epilogue_plain on its operands, the launches read from each
     pass's own counters; then each distinct call timed, kernel and plain
     chain, as CUDA-graph replays, beside its byte bound;
  4b. context models whose weights pass a block's shared memory (kf = 64,
     seeded): the K=3 main path with `pc cvpr/res_shallow_64` and the
     trained AE at B=16, kernel 2's tables there against its scan and its
     plain version, the compile-time kf = 64 instance against the generic
     one, and at kf = 24 the weights in device memory against shared
     memory; the K=3 main path at `ae cvpr/hi` (C = 64) + res_shallow_64,
     B=4; the K=5 main path with `pc base` at kf = 64, B=16, and kernel 5's
     tables against its scan (placement, cluster size and times printed);
  6. the training path at full width (ae cvpr/low + pc cvpr/res_shallow,
     B=30 160x160 crops of synthetic:64, seeded weights): kernel 1 against
     its plain version on the z that the training forward hands it, one
     backward with kernel 7 against one with its plain version, 20 train steps on one
     batch (twice from the same seed), an eval step, per-step times, and
     train_loop.train with a test interval, a save and a restore;
  7. the validation path (eval/validate.py, val_torch.py) at full width:
     the trained ae cvpr/low + pc cvpr/res_shallow saved as checkpoint 9000
     through the Saver and the tree of train_loop.train, in a log dir named
     for the configs under build/chip_smoke_val; kernel 1 against its plain
     version on the eval z (symbols and all); on the symbols fetch_many
     gives the first bucket, kernel 2's encode tables and kernel 3's output
     at B=8 against their plain versions (byte for byte for kernel 3);
     validate() on the 24 images of work_rd/natkodak24 (512x768, eval
     batch 8: three full buckets) without and with real_bpp and save_ours:
     24 measures rows equal in both sweeps and the summary, every bucket's
     batched round trip CRC-verified bit-exact (so the scan decode at B=8),
     the real / theoretical / loss bpp and the real/theory overhead (at
     most 1%), 24 PNGs of 512x768, images a second by CUDA events around
     fetch_many and the codec calls; one fetch_many of the first bucket
     under torch.profiler, its device time split by validate's ic.val.<step>
     ranges; val_torch.py --how_many 5 (one bucket of 5 padded to 8) gives
     the full sweep's first five rows exactly (pad_batch_to); a K=5 run
     (trained AE, seeded pc base, --how_many 4 --real_bpp) launches kernels
     5 and 6 and round-trips, and on its 4 images kernel 5's encode tables
     and kernel 6's output are held against their plain versions. Phase
     6c's own run (image dumps at its
     test step, d_BPG NaN without BPG curves, its registry entry) is
     validated once by val_torch.py on 8 images, its last checkpoint;
  8. the tools (imgcomp_cvpr_tpu_torch/tools) at full width: codec_cli's
     compress / decompress / roundtrip with the trained npz on 3 natkodak24
     images and a 509x765 crop of one (every .icz file CRC-verified and
     decoded twice to the same pixels; bpp and ms of each mode printed), and
     --log_dir on phase 7's K=5 checkpoint (kernels 5 and 6); profile_codec
     at B=8 (its JSON report); ab_streams dump twice, compare and cross for
     the cuda and cuda_planar codecs; parity_check on a TF1 checkpoint that
     the port's pure exporter writes from the trained npz, over 8 natkodak24
     images: PASS against phase 7's bpp and MS-SSIM for those images, FAIL at
     1.2x the bpp. Kernels 1, 2, 3, 5 and 6 must launch, and each is held
     to its plain version on the inputs the tools gave it (not counted);
  9. data parallelism. 9b: the data-parallel train step at full width on
     phase 6's batch: world size 1 under NCCL, 2 steps (loss, the averaged
     gradients, the parameters) equal bit for bit to 2 non-parallel steps
     (deterministic cuDNN), its ms a step beside the non-parallel eager
     step's (the cost of the collectives), phase 6b's and the non-parallel
     step's as CUDA-graph replays; then 2 spawned ranks sharing the card under gloo
     against 1 rank, one step, the averaged gradients included (held to
     twice the distance between one rank's gradients on the batch and on
     the batch reversed).
     9c: phase 7's sweep with and without real_bpp, and its K=5 run,
     through EvalModel and LatentCodec given the card twice: phase 7's
     measures rows and stream bytes exactly;
 10. kernel 2 at its operand precisions bf16 and f8 (container prec 1 and
     2) with the trained K=3 model on phase 4's images: per precision the
     main path through LatentCodec(prec=...) (CRC-verified bit-exact, prec
     byte checked, its own kernel-2 instance launched and the f32 one not)
     and its legs once more in a second pass, bpp and theory against f32 on the same symbols, kernel 2's
     layer-parallel tables equal to its scan's mode-1 tables and to its
     plain version's on every entry, 3a / 3b ms, the plain decode of the
     same streams, the operands' bytes over the HBM rate; seeded kf = 64 (weights in device memory) and kf = 8
     (generic instance) context models at B=2 through the same checks;
     the streams of ab_streams' workload at K=3 (prec 0, 1 and 2) and K=5
     (prec 0) against the parent commit's digests (AB_DIGESTS); non-finite
     inputs at B=2: the trained K=3 model with layer 1's hottest channel
     scaled past the f8 ring's range (464), kernel 2's f8 layer-parallel,
     scan and plain tables equal on every entry, the all-ones columns (a
     NaN logit) counted (fail at 0) and the f8 round trip CRC-verified; the
     same for kernel 5 with phase 5's seeded K=5 model, its last layer
     scaled to +inf logits; and, recorded only, phase 7's K=5 checkpoint
     encoded outside cuDNN's deterministic scope and decoded inside it and
     the other way round (CRC, symbols and table entries off);
 11. the entry points of graft_entry_torch.py on the card: entry()
     against the same step on the CPU, and dryrun_multichip(1) (an NCCL
     world-1 train step, EvalModel, a LatentCodec round trip);
 12. the kernels line: each kernel's launches in its main-path phase (4, 5
     or 6; kernel 2's bf16 and f8 rows: phase 10), its error against the
     plain version, times and bound (the bf16 and f8 rows count their
     operations at the bf16 rate, the type of their operands); the
     kernels of phase 7's real-bpp runs also give ``launches_validation``
     (phase 7's count, K=3 sweep and K=5 run), those of the tools
     ``launches_tools`` (phase 8's count), every kernel
     ``launches_parallel`` (phase 9's data-parallel runs: 9b's train steps
     for kernels 1 and 7, 9c's real-bpp validation for 1, 2, 3, 5, 6) and
     ``launches_entry`` (phase 11's count). Kernel 1
     has two rows: ``quantize`` (codec shape, phase 4's launches) and
     ``quantize_train`` (training shape, phase 6b's launches). Kernels 1
     and 7 are short beside the host work of a wrapper call, so their rows
     also give the device time a call (``device_ms``, torch.profiler's
     CUPTI kernel records; ``ms`` is this one), the time a call inside a
     CUDA graph (``graph_ms``), the host us a wrapper call and the kernels
     it launches (quantizer_times). The ``ae_epilogue`` row has no Pallas
     counterpart (XLA fused the chain on the TPU): its ms, plain_ms and
     bound are sums over the bf16 B=16 round trip's 70 calls, ``passes``
     gives each pass of phase 4d by call.
The last line is {"ok": true, "device": {...}}. Any failed check raises,
which exits non-zero before that line is printed.
"""

import contextlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12        # bf16 dense, tensor cores (the H100 SXM data sheet)
FADD_LATENCY_CLOCKS = 4         # dependent f32 add to add, Hopper
ALU_LATENCY_CLOCKS = 4          # dependent integer ALU op to op, Hopper
# Dependent instructions of one sub-iteration's state update in the SASS of
# csrc/rans_reverse.cu (cuobjdump -sass of the sm_90a build): ISETP (emit),
# SHF (renorm, predicated), IMAD.HI (quotient), IMAD (remainder), ISETP
# (correction), IADD (predicated correction).
REVERSE_CHAIN_INSTRS = 6
ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'assets',
                     'demo_trained_low_9000.npz')
BATCH, IMG_H, IMG_W = 16, 512, 768
TRAIN_BATCH, TRAIN_CROP, TRAIN_STEPS = 30, 160, 20
HERE = os.path.dirname(os.path.abspath(__file__))
NATKODAK = os.path.join(HERE, 'work_rd', 'natkodak24')   # 24 PNGs of 512x768
VAL_ROOT = os.path.join(HERE, 'build', 'chip_smoke_val')  # phase 7's log root
VAL_BATCH, VAL_IMAGES = 8, 24
TOOLS_ROOT = os.path.join(HERE, 'build', 'chip_smoke_tools')  # phase 8's files
PREC_ROOT = os.path.join(HERE, 'build', 'chip_smoke_prec')    # phase 10's files
OVERHEAD_LIMIT_PCT = 1.0    # real/theory bits at Kodak size, trained model (PERF.md)


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


def quantizer_times(fn, match, calls=50):
    """What one wrapper call of kernel 1 or 7 costs, four ways: device ms a
    call (torch.profiler's CUPTI kernel records whose name contains `match`
    over `calls` calls: their mean duration times the kernels a call; None
    if the profiler records no device kernel), kernels launched a call (the
    records over the calls, rounded: CUPTI may drop a few records of
    microsecond kernels), device ms a call from CUDA events around the
    replay of a CUDA graph of `calls` calls (no host work between the
    kernels; the launch gaps inside the graph included), and host us a call
    (the wrapper's enqueue on the host clock: the median of 10 runs of 50
    calls without a synchronise, the host being shared and noisy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    recs = [e for e in prof.key_averages() if match in e.key]
    dev_us = sum(getattr(e, 'device_time_total', None) or getattr(e, 'cuda_time_total', 0)
                 for e in recs)
    records = sum(e.count for e in recs)
    per_call = round(records / calls)
    g_ms = graph_ms(fn, calls)
    runs = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            fn()
        runs.append((time.perf_counter() - t) / 50 * 1e6)
    torch.cuda.synchronize()
    return dict(device_ms=dev_us / records * per_call / 1e3 if records else None,
                launches_per_call=per_call if records else None, records=records,
                graph_ms=g_ms, host_us_per_call=float(np.median(runs)))


def graph_ms(fn, calls):
    """Device ms a call of fn(): CUDA events around 5 replays of a CUDA graph
    of `calls` calls (no host work between the kernels; the launch gaps
    inside the graph included), after a warm-up call on the capture stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (5 * calls)
    del graph
    return ms


def quantizer_line(label, t, bound_ms):
    dev = 'not recorded' if t['device_ms'] is None else f'{t["device_ms"] * 1e3:.2f} us'
    return (f'{label}: device {dev} a call (torch.profiler, {t["launches_per_call"]} kernels '
            f'a call, {t["records"]} records), {t["graph_ms"] * 1e3:.2f} us a call in a CUDA '
            f'graph, host {t["host_us_per_call"]:.1f} us a wrapper call (median); bound '
            f'{bound_ms * 1e3:.2f} us')


def quantizer_only(root):
    """`--quantizer-only [--root DIR]`: kernels 1 and 7 alone at the main
    path's shapes (seeded inputs of the codec z and the training z), held to
    their plain versions and timed by quantizer_times; DIR (a checkout of
    another commit) supplies the package instead of this one. Prints one
    JSON line."""
    import torch
    if root:
        sys.path.insert(0, os.path.abspath(root))
    from imgcomp_cvpr_tpu_torch.ops.kernels import build, quantize as qk
    if root and not os.path.abspath(build.__file__).startswith(os.path.abspath(root)):
        raise AssertionError(f'package not taken from {root}')
    dev = torch.device('cuda')
    logs = build.build_all()
    for name in ('quantize', 'quantize_bwd'):
        print(f'[q build] {name}: ' + ' | '.join(ptxas_summary(logs.get(name, ''))), flush=True)
    rng = np.random.RandomState(0)
    centers = torch.from_numpy(np.sort(rng.uniform(-2, 2, 6)).astype(np.float32)).to(dev)
    out = {}
    for name, shape in (('quantize', (BATCH, IMG_H // 8, IMG_W // 8, 32)),
                        ('quantize_train', (TRAIN_BATCH, TRAIN_CROP // 8, TRAIN_CROP // 8, 32))):
        z = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 1.5).to(dev)
        k, p = qk.quantize_fwd(z, centers), qk.quantize_plain(z, centers)
        if not (torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])):
            raise AssertionError(f'{name}: symbols or qhard differ from the plain version')
        t = quantizer_times(lambda: qk.quantize_fwd(z, centers), 'quantize_fwd')
        out[name] = dict(t, bound_ms=bound(16 * z.numel(), 0)[0],
                         qsoft_err=(k[0] - p[0]).abs().max().item())
        print(quantizer_line(f'[q {name}] z {shape}', t, out[name]['bound_ms']), flush=True)
    x, g = (torch.from_numpy(rng.randn(*shape).astype(np.float32) * s).to(dev)
            for s in (1.5, 1.0))
    dx, dc = qk.quantize_bwd(x, centers, g, None)
    px, pc_ = qk.quantize_bwd_plain(x, centers, g, None)
    t = quantizer_times(lambda: qk.quantize_bwd(x, centers, g, None), 'quantize_bwd')
    out['quantize_bwd'] = dict(t, bound_ms=bound(12 * x.numel(), 0)[0],
                               dx_err=(dx - px).abs().max().item(),
                               dc_err=(dc - pc_).abs().max().item())
    print(quantizer_line(f'[q quantize_bwd] x {shape}', t, out['quantize_bwd']['bound_ms']),
          flush=True)
    print(json.dumps({'root': root or '.', 'device': torch.cuda.get_device_name(0),
                      'quantizer': out}), flush=True)
    return 0


def kernel2_only(root, profile=False):
    """`--kernel2-only [--root DIR]`: kernel 2 alone with the trained K=3
    context model at the main path's shape (B=16, latent (32, 64, 96)) on
    seeded symbols (most on the two middle centers, as the trained AE puts
    them): the layer-parallel encode (3a) and the scan decode (3b) at each
    operand precision the package has, the decode held to the symbols, and
    a sha256 of each precision's tables and of the streams kernel 3 writes
    from them (two checkouts whose digests agree wrote the same bytes).
    First, before any of that, the main path (main_path, LatentCodec at
    each precision, f32 first, on phase 4's images) twice a precision: the
    entropy encode and decode legs of its first pass in the process and of
    a second; with `--profile` the first pass of each precision runs under
    torch.profiler, which prints its 8 operators of most host time. DIR (a
    checkout of another commit) supplies the package instead of this one.
    Then kernel 5 (kernel5_times) on the same symbols with phase 5's
    seeded pc base. Prints one line a precision, one for kernel 5 and one
    JSON line."""
    import hashlib
    import torch
    if root:
        sys.path.insert(0, os.path.abspath(root))
    from imgcomp_cvpr_tpu_torch import weights as weights_lib
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib, cuda_codec, cuda_kernel as ck
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
    from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib
    if root and not os.path.abspath(build.__file__).startswith(os.path.abspath(root)):
        raise AssertionError(f'package not taken from {root}')
    dev = torch.device('cuda')
    logs = build.build_all()
    for name in [n for n in ('wavefront_forward', 'plane_forward') if logs.get(n)]:
        print(f'[k2 build] {name}: ' + ' | '.join(
            f'{fn} {regs}' for fn, regs in ptxas_kernels(logs[name]).items()), flush=True)
    ae_config, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc_config, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    ae = ae_lib.CVPRAutoencoder(ae_config, device=dev)
    pc = pc_lib.ProbClassifier(pc_config, ae_config.num_centers, device=dev)
    ae, pc = weights_lib.load_trained(ASSET, ae, pc, device=dev)
    precs = getattr(ck, 'PRECS', ('f32',))
    x = torch.from_numpy(natural_images(np.random.RandomState(0), BATCH, IMG_H, IMG_W)).to(dev)
    legs = {}
    for prec in precs:
        lc = codec_lib.LatentCodec(pc, pc_config, device=dev, prec=prec)
        passes = []
        for i in range(2):
            if profile and i == 0:
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as pr:
                    passes.append(main_path(ae, lc, x, ae.encoder.centers.detach())[1]['legs'])
                print(f'[k2 {prec} profile of the first pass]\n' + pr.key_averages().table(
                    sort_by='self_cpu_time_total', row_limit=8), flush=True)
            else:
                passes.append(main_path(ae, lc, x, ae.encoder.centers.detach())[1]['legs'])
        legs[prec] = {k: [ps[i] for ps in passes] for i, k in ((1, 'entropy_encode_ms'),
                                                               (2, 'entropy_decode_ms'))}
        print(f'[k2 {prec} main path] entropy encode {passes[0][1]:.3f} ms then '
              f'{passes[1][1]:.3f}, decode {passes[0][2]:.3f} then {passes[1][2]:.3f}'
              + (' (the first pass profiled)' if profile else ''), flush=True)
    shape = (ae_config.num_chan_bn, IMG_H // 8, IMG_W // 8)
    n = int(np.prod(shape))
    rng = np.random.RandomState(0)
    syms = torch.from_numpy(rng.choice(6, size=(BATCH, n), p=[.02, .08, .4, .4, .08, .02]))
    syms = syms.int().to(dev)
    fw = cuda_codec.fold_weights(pc, ae.encoder.centers.detach())
    out = {}
    for prec in precs:
        kw = {} if prec == 'f32' else {'prec': prec}
        f, s = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=syms, **kw)
        enc_ms = cuda_ms(lambda: ck.wavefront_forward(ck.MODE_ENCODE, fw, shape,
                                                      true_syms=syms, **kw), 5)
        args = dict(k3_streams(f, s, shape)[0], **kw)
        if not torch.equal(ck.wavefront_forward(ck.MODE_DECODE, fw, shape, **args), syms):
            raise AssertionError(f'kernel 2 at {prec}: the scan did not recover the symbols')
        dec_ms = cuda_ms(lambda: ck.wavefront_forward(ck.MODE_DECODE, fw, shape, **args), 3)
        bits = float(-torch.log2(f.double().clamp(min=1) / 65536).sum().item())
        digests = {k: hashlib.sha256(b''.join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()
                   for k, ts in (('tables', (f, s)), ('streams', (args['streams'],
                                                                  args['init_states'],
                                                                  args['thresh'])))}
        out[prec] = dict(encode_ms=enc_ms, decode_ms=dec_ms, theory_bits=bits, **digests,
                         main_path=legs[prec])
        print(f'[k2 {prec}] 3a encode {enc_ms:.3f} ms, 3b decode {dec_ms:.3f} ms, theory '
              f'bits {bits:.0f}, tables sha256 {digests["tables"][:16]}, streams sha256 '
              f'{digests["streams"][:16]}', flush=True)
    pc5_config, _ = config_lib.parse_spec('base', 'pc')
    pc5 = pc_lib.init_params(pc_lib.ProbClassifier(pc5_config, ae_config.num_centers,
                                                   device=dev), seed=0)
    k5 = kernel5_times(pc5, pc5_config, syms.reshape((BATCH,) + shape),
                       ae.encoder.centers.detach())
    staged = (f'; the staged path {k5["staged_ms"]:.3f} ms, clocks {k5["staged_clocks"]}'
              if 'staged_ms' in k5 else '')
    print(f'[k5] 5a encode {k5["encode_ms"]:.3f} ms a batch ({k5["encode_ms"] / 5:.3f} a '
          f'launch: {[round(t, 3) for t in k5["launch_ms"]]}), 5b decode {k5["decode_ms"]:.3f} '
          f'ms a plane launch on the {k5["decode_path"]} path (clocks a step, levels 1-4 and '
          f'CDF + rANS: {k5["decode_clocks"]}){staged}, tables sha256 {k5["tables"][:16]}, '
          f'streams sha256 {k5["streams"][:16]}', flush=True)
    print(json.dumps({'root': root or '.', 'device': torch.cuda.get_device_name(0),
                      'kernel2': out, 'kernel5': k5}), flush=True)
    return 0


def kernel5_times(pc5, pc5_config, syms, centers, plane=2):
    """Kernel 5 alone (the `--kernel2-only` run): the layer-parallel encode
    (5a; its 5 launches timed by planar_encode_launch_ms), kernel 6 on its
    tables, then the scan decode of every plane up to ``plane`` with plane
    ``plane``'s launch timed (5b) and its clocks a step by phase (the
    kernel's ``prof``), the decode held to the symbols; sha256s of the
    tables and of kernel 6's streams. Where the scan took its ring path, the
    staged path (FORCE_STAGED) is timed on the same plane too."""
    import hashlib
    import torch
    from imgcomp_cvpr_tpu_torch.coding import planar, planar_codec
    from imgcomp_cvpr_tpu_torch.coding import planar_kernel as plk
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    dev = syms.device
    B, C, H, W = syms.shape
    shape = (C, H, W)
    syms = syms.int().contiguous()
    coder = planar_codec.PlanarCoder(pc5, pc5_config, device=dev)
    sched, fold = coder._prepare(shape, centers)
    launch_ms, _, (fsel, ssel), _ = planar_encode_launch_ms(coder, syms, fold)
    w, n_w, st, k = plk.plane_reverse(fsel, ssel, shape, coder.K, 1)
    streams = torch.zeros(B, sched.stream_cap, dtype=torch.int32, device=dev)
    for i in range(B):
        streams[i, :n_w[i]] = w[i, :n_w[i]].flip(0)
    thresh = (torch.from_numpy(coder.lane_totals(shape)).to(dev)[None] - k).int()
    plane_tot = torch.from_numpy(planar.plane_totals(sched)).to(dev)
    states, gptr = st, torch.zeros(B, dtype=torch.int32, device=dev)
    hist = coder._history(fold, sched, B)
    for d in range(plane + 1):
        bias = coder.bias_rows(fold, hist)
        args = dict(streams=streams, states=states, gptr=gptr,
                    thresh=(thresh - d * plane_tot).int().contiguous())
        out = plk.plane_forward(plk.MODE_DECODE, fold.top, shape, coder.K, bias, **args)
        if not torch.equal(out.syms, syms[:, d]):
            raise AssertionError(f'kernel 5: the scan did not recover plane {d}')
        states, gptr = out.states, out.gptr
        coder._push(hist, out)
    rings = build.LAUNCHES.get('plane_ring', 0)
    dec_ms = cuda_ms(lambda: plk.plane_forward(plk.MODE_DECODE, fold.top, shape, coder.K,
                                               bias, **args), 3)
    path = 'ring' if build.LAUNCHES.get('plane_ring', 0) > rings else 'staged'
    clocks = decode_clocks(plk, fold, shape, coder.K, bias, args, sched.T2)
    digest = {key: hashlib.sha256(b''.join(t.cpu().numpy().tobytes() for t in ts)).hexdigest()
              for key, ts in (('tables', (fsel, ssel)), ('streams', (w, n_w, st, k)))}
    out = dict(encode_ms=sum(launch_ms), launch_ms=launch_ms, decode_ms=dec_ms,
               decode_path=path, decode_clocks=clocks, **digest)
    if path == 'ring':      # the staged path on the same plane, in the same process
        staged = dict(args, force=plk.FORCE_STAGED)
        out['staged_ms'] = cuda_ms(lambda: plk.plane_forward(
            plk.MODE_DECODE, fold.top, shape, coder.K, bias, **staged), 3)
        out['staged_clocks'] = decode_clocks(plk, fold, shape, coder.K, bias, staged, sched.T2)
    return out


def decode_clocks(plk, fold, shape, K, bias, args, steps):
    """Kernel 5's scan clocks a step (the kernel's ``prof``, mean over the
    images): levels 1-4, each with its barrier, and CDF + rANS."""
    import torch
    prof = torch.zeros(bias[0].shape[0], 5, dtype=torch.int64, device=bias[0].device)
    plk.plane_forward(plk.MODE_DECODE, fold.top, shape, K, bias, prof=prof, **args)
    return (prof.double().mean(0) / steps).round().long().tolist()


def ptxas_summary(log):
    """ptxas -v's lines of one build that give, function by function, the
    stack frame and spills, then (for a kernel) its registers."""
    return [l.split(':', 1)[-1].strip() if 'registers' in l else l.strip()
            for l in log.splitlines() if 'registers' in l or 'stack frame' in l]


def ptxas_kernels(log):
    """ptxas -v's log of one build -> {kernel (mangled name): 'N registers'
    and, where ptxas reports any, its spill stores and loads}."""
    out, fn, spill = {}, None, ''
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            fn, spill = line.split("'")[1], ''
        elif 'spill stores' in line and '0 bytes spill stores, 0 bytes spill loads' not in line:
            spill = ', ' + line.split(',', 1)[-1].strip()
        elif 'registers' in line and fn:
            out[fn] = line.split('Used', 1)[-1].split(',')[0].strip() + spill
            fn = None
    return out


def host_ms(fn):
    """ms of one fn() call on the host clock, synchronised (for the plain
    versions, whose Python loops take seconds)."""
    import torch
    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return (time.time() - t) * 1e3, out


def chain_floor_ms(adds_per_step, steps, sm_mhz):
    """The least a scan can take on one image with today's summation order:
    its dependent adds at the card's add latency and top SM clock."""
    return adds_per_step * steps * FADD_LATENCY_CLOCKS / (sm_mhz * 1e3)


def same_reverse(a, b, pairs):
    """Whether two reverse encoders' outputs (words, n_words, states, k)
    agree byte for byte on image i of a and image j of b for (i, j) in
    pairs."""
    import torch
    wa, na, sa, ka = a
    wb, nb, sb, kb = b
    return all(int(na[i]) == int(nb[j]) and torch.equal(wa[i, :na[i]], wb[j, :nb[j]])
               and torch.equal(sa[i], sb[j]) and torch.equal(ka[i], kb[j])
               for i, j in pairs)


def reverse_kernel(label, run, plain, fsel, ssel, x0, sm_mhz):
    """Phase 3 for kernel 3 or 6 on the B-image tables of the main path:
    ``run(fsel, ssel, x0, prof=None)`` (the wrapper) byte-identical to
    ``plain(fsel, ssel, x0)``; the first three images run as a batch of 3
    and one by one give their B-image outputs; a run with the clock profile
    gives the same outputs. Returns (outputs, plain outputs, plain ms,
    kernel ms, profile: rows run, mean clocks a non-empty sub-iteration,
    clocks of it in the state updates, shares of the chain warp's clocks
    that it, the producer warps and the writer warp spent waiting, chain
    floor ms)."""
    import torch
    B = fsel.shape[0]
    out = run(fsel, ssel, x0)
    plain_ms, ref = host_ms(lambda: plain(fsel, ssel, x0))
    if not same_reverse(out, ref, [(i, i) for i in range(B)]):
        raise AssertionError(f'{label}: output differs from the plain version')
    three = run(fsel[:3], ssel[:3], x0)
    if not (same_reverse(three, out, [(i, i) for i in range(3)])
            and all(same_reverse(run(fsel[i:i + 1], ssel[i:i + 1], x0), out, [(0, i)])
                    for i in range(3))):
        raise AssertionError(f'{label}: B=3 or B=1 outputs differ from the B={B} run\'s')
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
    prof = torch.zeros(B, ck.REVERSE_PROF, dtype=torch.int64, device=fsel.device)
    if not same_reverse(run(fsel, ssel, x0, prof), out, [(i, i) for i in range(B)]):
        raise AssertionError(f'{label}: outputs differ with the clock profile on')
    p = prof.double()
    rows_run = int(prof[0, 2].item())
    if rows_run < 1 or (prof[:, 2] != rows_run).any():
        raise AssertionError(f'{label}: profile counts {prof[:, 2].tolist()} sub-iterations')
    stats = dict(rows=rows_run, clocks=(p[:, 0] / p[:, 2]).mean().item(),
                 wait=(p[:, 1] / p[:, 0]).mean().item(),
                 producer_wait=((p[:, 3] + p[:, 4]) / (2 * p[:, 0])).mean().item(),
                 writer_wait=(p[:, 5] / p[:, 0]).mean().item(),
                 update=(p[:, 6] / p[:, 2]).mean().item(),
                 floor_ms=REVERSE_CHAIN_INSTRS * ALU_LATENCY_CLOCKS * rows_run / (sm_mhz * 1e3))
    return out, ref, plain_ms, cuda_ms(lambda: run(fsel, ssel, x0), 3), stats


def reverse_line(label, B, nw, ms, stats, sm_mhz):
    return (f'[3 {label}] words/n_words/states/k byte-identical to the plain version at '
            f'B={B} ({nw} words); B=3 and B=1 outputs equal the B={B} run\'s; {ms:.3f} ms; '
            f'profile (mean over the images): {stats["rows"]} non-empty sub-iterations, '
            f'{stats["clocks"]:.1f} clocks each, of which {stats["update"]:.1f} in the state '
            f'updates; {100 * stats["wait"]:.2f}% of the chain warp\'s clocks waiting for '
            f'tiles (the producer warps wait {100 * stats["producer_wait"]:.2f}% of as many '
            f'clocks, the writer warp {100 * stats["writer_wait"]:.2f}%); chain floor '
            f'{stats["floor_ms"]:.4f} ms '
            f'({REVERSE_CHAIN_INSTRS} dependent instructions x {ALU_LATENCY_CLOCKS} clocks x '
            f'{stats["rows"]} sub-iterations at {sm_mhz} MHz)')


def library_logits_ms(pc, centers, syms, dtype=None):
    """ms of the port's own ProbClassifier.logits (F.conv3d chain, f32, TF32
    off; with ``dtype`` a copy of the context model and the latent in that
    type) on the same symbols, one image a call as the codecs' convolutions
    run: the one PyTorch call chain that computes the kernels' logits. It
    stops there: no CDF, no selection of the coded symbol's entry. The codec
    path never calls it."""
    import copy
    import torch
    from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
    if torch.backends.cudnn.allow_tf32:
        raise AssertionError('TF32 convolutions are on')
    pad = float(pc_lib.auto_pad_value(pc.config, centers, pc))
    q = centers[syms.long()].permute(0, 2, 3, 1).contiguous()
    if dtype is not None:
        pc, q = copy.deepcopy(pc).to(dtype), q.to(dtype)

    def run():
        with torch.no_grad():
            for i in range(q.shape[0]):
                pc.logits(q[i:i + 1], pad)

    return cuda_ms(run, 2)


def planar_encode_launch_ms(coder, syms, fold):
    """One PlanarCoder.encode_tables call after a warm-up, with CUDA events
    around each of its kernel-5 launches (levels 1-4, tables): (their ms,
    the host ms of the call, its tables, the kernel-5 launches it counted)."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import planar_kernel as plk
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    spans = []

    def timed(fn):
        def run(*a, **k):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            spans.append(ev)
            return out
        return run

    kernel_calls = plk.level_forward, plk.plane_tables
    plk.level_forward, plk.plane_tables = timed(plk.level_forward), timed(plk.plane_tables)
    try:
        coder.encode_tables(syms, fold)                       # warm-up
        spans.clear()
        before = build.LAUNCHES['plane_forward_encode']
        all_ms, tables = host_ms(lambda: coder.encode_tables(syms, fold))
        launches = build.LAUNCHES['plane_forward_encode'] - before
    finally:
        plk.level_forward, plk.plane_tables = kernel_calls
    return [a.elapsed_time(b) for a, b in spans], all_ms, tables, launches


def planar_kernels(dev, syms, centers, pc5, pc5_config, rows, sm_mhz):
    """Phase 3 for kernels 5 and 6 at the main path's shapes (B=16, latent
    (32, 64, 96), K=5). The layer-parallel encode is held against its plain
    version and against the teacher-forced scan on every plane; the scan is
    held against its own plain version on plane P = 2 in both modes, and
    its ring path timed against its staged path there. Adds rows to
    ``rows``."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import planar, planar_codec
    from imgcomp_cvpr_tpu_torch.coding import planar_kernel as plk
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    P = 2
    B, C, H, W = syms.shape
    shape = (C, H, W)
    coder = planar_codec.PlanarCoder(pc5, pc5_config, device=dev)
    sched, fold = coder._prepare(shape, centers)
    K, kf, L = coder.K, fold.top.w1.shape[-1], coder.L
    syms = syms.int().contiguous()
    act = torch.from_numpy(sched.idx_cm < H * W).to(dev)
    entries = int(act.sum().item()) * B

    # The layer-parallel encode, with each of its kernel launches timed.
    par_ms, all_ms, (fsel_par, ssel_par), n_par = planar_encode_launch_ms(coder, syms, fold)
    if n_par != 5 or len(par_ms) != 5:
        raise AssertionError(f'plane forward encode: {n_par} kernel-5 launches a batch')
    enc_plain_ms, (f_pl, s_pl) = host_ms(lambda: coder.encode_tables(syms, fold, plain=True))
    flips_all = int(((fsel_par != f_pl) | (ssel_par != s_pl)).sum().item())
    if flips_all > 1e-3 * entries * C:
        raise AssertionError(f'plane forward encode: {flips_all} flips vs plain')

    # The teacher-forced scan over every plane (the oracle); keep plane P's inputs.
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
    if not (torch.equal(fsel.reshape(B, -1, planar.R), fsel_par)
            and torch.equal(ssel.reshape(B, -1, planar.R), ssel_par)):
        raise AssertionError('plane forward encode: layer-parallel tables differ from '
                             'the scan\'s mode-1 tables')
    true_p = syms[:, P].contiguous()
    plain_ms, op = host_ms(lambda: plk.plane_forward_plain(
        plk.MODE_ENCODE, fold.top, shape, K, bias_p, true_plane=true_p))
    flips = int((((out_p.fsel != op.fsel) | (out_p.ssel != op.ssel)) & act).sum().item())
    if flips > 1e-3 * entries:
        raise AssertionError(f'plane forward encode: {flips} flips > 0.1% of {entries}')
    act_err = max((a - b).abs().max().item()
                  for a, b in zip(out_p.acts + (out_p.q,), op.acts + (op.q,)))
    if act_err > 1e-5:
        raise AssertionError(f'plane forward encode: activations max abs err {act_err}')
    # Per plane of B images: top-slice tap products of every level cell;
    # bias rows and true symbols read, activations, q plane and (freq,
    # start) tables written. The encode does all C planes in its 5 launches:
    # its row gives the mean over them, a fifth of the batch's.
    cells = [g[0] * g[1] for g in sched.grids]
    flops = 2 * B * sum(cells[l + 1] * len(sched.taps[l]) * (1 if l == 0 else kf)
                        * (L if l == 3 else kf) for l in range(4))
    io = 4 * B * (sum(cells[1:4]) * kf * 2 + cells[4] * L + cells[0])
    enc_bytes = io + 4 * B * (H * W + 2 * sched.T2 * planar.R)
    scan_enc_ms = cuda_ms(lambda: plk.plane_forward(plk.MODE_ENCODE, fold.top, shape, K,
                                                    bias_p, true_plane=true_p), 3)
    lib_ms = library_logits_ms(pc5, centers, syms)
    rows['plane_forward_encode'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/plane_forward.cu',
        replaces='imgcomp_cvpr_tpu/coding/planar_kernel.py:393',
        max_abs_err=float((fsel_par - f_pl).abs().max().item()),
        ms=sum(par_ms) / 5, plain_ms=enc_plain_ms / 5,
        bound=bound(C * enc_bytes / 5, C * flops / 5), library_ms=lib_ms / 5)
    print(f'[3 plane forward encode] K=5 latent {shape}: layer-parallel encode of all {C} '
          f'planes in {n_par} kernel-5 launches, ms {[round(t, 3) for t in par_ms]} (levels '
          f'1-4, tables) = {sum(par_ms):.3f} of the {all_ms:.1f} ms encode_tables takes with '
          f'its 4 bias-row launches; tables equal to the teacher-forced '
          f'scan\'s on all {C} planes ({fsel_par.numel()} entries); vs the plain '
          f'layer-at-a-time version on all planes ({enc_plain_ms / 1e3:.1f} s): {flips_all} '
          f'flips of {entries * C} active entries (tol 0.1%); the scan ({scan_enc_ms:.3f} ms '
          f'a plane) vs its plain loop on plane {P} ({plain_ms / 1e3:.1f} s): {flips} flips '
          f'of {entries}, activations max abs err {act_err:.3g}; ProbClassifier.logits '
          f'(F.conv3d, f32, TF32 off, logits only: no CDF, no selection) on the same '
          f'symbols {lib_ms:.3f} ms a batch; the row gives a fifth of the batch\'s times',
          flush=True)

    fsel = fsel.reshape(B, -1, planar.R)
    ssel = ssel.reshape(B, -1, planar.R)
    x0 = 1
    (w_k, n_k, st_k, k_k), (w_p, n_p, _, _), rev_plain_ms, rev_ms, stats = reverse_kernel(
        'plane_reverse',
        lambda f, s, x, prof=None: plk.plane_reverse(f, s, shape, K, x, prof),
        lambda f, s, x: plk.plane_reverse_plain(f, s, shape, K, x), fsel, ssel, x0, sm_mhz)
    nw = int(n_k.sum().item())
    rows['plane_reverse'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/rans_reverse.cu',
        replaces='imgcomp_cvpr_tpu/coding/planar_kernel.py:540',
        max_abs_err=float(max((w_k[i, :n_k[i]] - w_p[i, :n_p[i]]).abs().max().item()
                              for i in range(B) if n_k[i] > 0)),
        ms=rev_ms, plain_ms=rev_plain_ms,
        bound=bound(2 * 4 * fsel.numel() + 4 * nw + 8 * planar.R * B, 0),
        library_ms=None)
    print(reverse_line('plane_reverse', B, nw, rev_ms, stats, sm_mhz)
          + f' over {C} x {sched.T2} rows', flush=True)

    # Decode every plane through kernel 5 from kernel 6's streams.
    streams = torch.zeros(B, sched.stream_cap, dtype=torch.int32, device=dev)
    for i in range(B):
        streams[i, :n_k[i]] = w_k[i, :n_k[i]].flip(0)
    thresh = (torch.from_numpy(coder.lane_totals(shape)).to(dev)[None] - k_k).int()
    plane_tot = torch.from_numpy(planar.plane_totals(sched)).to(dev)
    states, gptr = st_k, torch.zeros(B, dtype=torch.int32, device=dev)
    hist = coder._history(fold, sched, B)
    dec = torch.empty_like(syms)
    rings = build.LAUNCHES['plane_ring']
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
    rings = build.LAUNCHES['plane_ring'] - rings
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
    adds = len(sched.taps[0]) + sum(len(tp) for tp in sched.taps[1:]) * kf
    clocks = decode_clocks(plk, fold, shape, K, bias_d, args_p, sched.T2)
    staged = dict(args_p, force=plk.FORCE_STAGED)
    staged_ms = cuda_ms(lambda: plk.plane_forward(plk.MODE_DECODE, fold.top, shape, K,
                                                  bias_d, **staged), 3)
    staged_clocks = decode_clocks(plk, fold, shape, K, bias_d, staged, sched.T2)
    print(f'[3 plane forward decode] kernel 5 recovers all {C} planes from kernel '
          f'6\'s streams (tail-packed, per-plane thresholds); the plain version '
          f'decodes plane {P} from the same state to the same symbols, state and '
          f'read pointer; {rows["plane_forward_decode"]["ms"]:.3f} ms a plane launch '
          f'({rings} of the {C} scans on the ring path; the staged path {staged_ms:.3f} ms, '
          f'clocks {staged_clocks}); clocks a step, mean over the images (levels 1-4 each with its barrier, CDF + '
          f'rANS): {clocks}; '
          f'chain floor {chain_floor_ms(adds, sched.T2, sm_mhz):.3f} ms a launch ({adds} '
          f'dependent adds a step x {sched.T2} steps x {FADD_LATENCY_CLOCKS} clocks at '
          f'{sm_mhz} MHz)', flush=True)


def bias_rows_volume(coder, fold, syms):
    """The activations the layer-parallel encode computes for ``syms`` (B,
    C, H, W), level by level as PlanarCoder.encode_tables does: per level
    0..3 the (B*C, H_l, W_l[, kf]) input of the next level's bias rows."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import bias_rows as br, planar
    from imgcomp_cvpr_tpu_torch.coding import planar_kernel as plk
    b, C, H, W = syms.shape
    shape = (C, H, W)
    sched = planar.build_planar_schedule(shape, coder.K)
    reach = planar.geometry(coder.K)[1]
    q = torch.full((b, C) + sched.grids[0], fold.pad, dtype=torch.float32, device=syms.device)
    q[:, :, reach:reach + H, reach:reach + W] = fold.top.centers[syms.long()]
    vol = [q.reshape((b * C,) + sched.grids[0])]
    for level in range(1, 4):
        vol.append(plk.level_forward(level, fold.top, shape, coder.K, vol[-1],
                                     br.level_rows(fold, level, vol[-1], C),
                                     skip=vol[1] if level == 3 else None))
    return vol


def bias_rows_layouts(fold, K, vol, b, C, plain=False):
    """The bias rows of every plane in both layouts: the encode's (one call a
    level over all b x C pairs) and the decode's (one call a plane for the
    four levels, the history pushed from ``vol``), each per level (b, C,
    H_l, W_l, cout); with their ms (CUDA events around all the calls of a
    layout)."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import bias_rows as br
    level_fn = br.level_rows_plain if plain else br.level_rows
    plane_fn = br.plane_rows_plain if plain else br.plane_rows
    grids = tuple(v.shape[1:3] for v in vol)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    enc = [level_fn(fold, level, vol[level - 1], C) for level in range(1, 5)]
    ev[1].record()
    per_image = [v.reshape((b, C) + v.shape[1:]) for v in vol]
    hist = br.history(b, grids, K // 2 + 1)
    dec = [[] for _ in range(4)]
    ev[2].record()
    for d in range(C):
        for level, r in enumerate(plane_fn(fold, hist)):
            dec[level].append(r)
        planes = [v[:, d].contiguous() for v in per_image]
        br.push(hist, planes[0], planes[1:])
    ev[3].record()
    torch.cuda.synchronize()
    enc = [e.reshape((b, C) + e.shape[1:]) for e in enc]
    return enc, [torch.stack(r, 1) for r in dec], ev[0].elapsed_time(ev[1]), \
        ev[2].elapsed_time(ev[3])


def bias_rows_kernel(dev, syms, centers, pc5, pc5_config, rows):
    """The bias-row kernel (csrc/bias_rows.cu) at the main path's shapes (B
    = 16, latent (32, 64, 96), K = 5 seeded pc base) on the activations
    the layer-parallel encode computes for phase 3's symbols: both layouts
    (the encode's 4 launches, the decode's 32) held to each other bit for
    bit, a B = 1 run of image 3 in both layouts to B = 16's rows of that
    image bit for bit, the kernel to its plain version (one cuDNN F.conv2d a
    (image, plane), TF32 off: the parent's path, so also the yardstick
    `library_ms`) within 2e-5 of max(1, |row|) (the sums of up to 1200
    float32 products in two orders), and the generic instance to the
    compile-time one bit for bit on the encode layout. Times each layout
    (kernel: mean of 3 runs) beside the bound, f32 operations at 67 TFLOP/s
    (or bytes, each activation read once and each row written once, at
    3.35 TB/s, were they more), and a batched cuDNN F.conv2d a level over
    all pairs (one call, not batch-invariant). Adds rows['bias_rows']."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import bias_rows as br, cuda_kernel as ck, planar_codec
    import torch.nn.functional as F
    syms = syms.int().contiguous()
    B, C = syms.shape[:2]
    coder = planar_codec.PlanarCoder(pc5, pc5_config, device=dev)
    K = coder.K
    _, fold = coder._prepare(tuple(syms.shape[1:]), centers)
    vol = bias_rows_volume(coder, fold, syms)
    enc, dec, _, _ = bias_rows_layouts(fold, K, vol, B, C)
    for level in range(4):
        if not torch.equal(enc[level], dec[level]):
            raise AssertionError(f'bias rows: level {level + 1} differs between the encode '
                                 f'and the decode layouts')
    one = [v.reshape((B, C) + v.shape[1:])[3].contiguous() for v in vol]
    enc1, dec1, _, _ = bias_rows_layouts(fold, K, one, 1, C)
    for level in range(4):
        if not (torch.equal(enc1[level][0], enc[level][3])
                and torch.equal(dec1[level][0], enc[level][3])):
            raise AssertionError(f'bias rows: level {level + 1} of image 3 differs between B = '
                                 f'1 and B = {B}')
    gen = [br.level_rows(fold, level, vol[level - 1], C, force=ck.FORCE_GENERIC)
           for level in range(1, 5)]
    if not all(torch.equal(g.reshape(e.shape), e) for g, e in zip(gen, enc)):
        raise AssertionError('bias rows: the generic instance differs from the compile-time one')
    runs = [bias_rows_layouts(fold, K, vol, B, C)[2:] for _ in range(3)]
    enc_ms, dec_ms = (sum(r[i] for r in runs) / len(runs) for i in range(2))
    enc_p, dec_p, enc_plain_ms, dec_plain_ms = bias_rows_layouts(fold, K, vol, B, C, plain=True)
    err = max((k - p).abs().max().item() for k, p in zip(enc + dec, enc_p + dec_p))
    scale = max(1.0, max(p.abs().max().item() for p in enc_p))
    if err > 2e-5 * scale:
        raise AssertionError(f'bias rows: kernel vs plain max abs err {err:.3g} > 2e-5 x {scale:.3g}')
    flops = nbytes = 0
    for level in range(1, 5):
        kd1, Kk, cin, cout = br._widths(fold, level)
        (hs, ws), (hl, wl) = vol[level - 1].shape[1:3], enc[level - 1].shape[2:4]
        flops += 2 * B * C * hl * wl * kd1 * Kk * Kk * cin * cout
        nbytes += 4 * B * C * (hs * ws * cin + hl * wl * cout)

    conv_w = [br.conv_weight(fold, level) for level in range(1, 5)]

    def batched():          # one cuDNN call a level over all (image, plane) pairs
        for level in range(1, 5):
            kd1, _, cin, _ = br._widths(fold, level)
            x = vol[level - 1]
            x = (x[:, None] if x.dim() == 3 else x.permute(0, 3, 1, 2)).reshape(B, C, cin,
                                                                               *x.shape[1:3])
            k = br._const(fold, level)[None, None, :, None, None].expand(B, kd1, cin,
                                                                        *x.shape[3:])
            x = torch.cat([k, x], 1)
            x = torch.stack([x[:, d:d + kd1] for d in range(C)], 1).reshape(
                B * C, kd1 * cin, *x.shape[3:])
            F.conv2d(x, conv_w[level - 1], fold.bias[level - 1])
    lib_ms = cuda_ms(batched, 2)
    b_ms, b_by = bound(nbytes, flops)
    rows['bias_rows'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/bias_rows.cu',
        replaces='none (conv_lower, left to XLA: imgcomp_cvpr_tpu/coding/planar_codec.py:260)',
        max_abs_err=err, ms=enc_ms + dec_ms, plain_ms=enc_plain_ms + dec_plain_ms,
        bound=(2 * b_ms, b_by), library_ms=2 * lib_ms, encode_ms=enc_ms, decode_ms=dec_ms,
        encode_plain_ms=enc_plain_ms, decode_plain_ms=dec_plain_ms)
    print(f'[3 bias rows] K={K} B={B} latent {tuple(syms.shape[1:])}: the encode layout (4 '
          f'launches) {enc_ms:.3f} ms, the decode layout ({C} launches) {dec_ms:.3f} ms, '
          f'round trip {enc_ms + dec_ms:.3f} ms against a bound of {2 * b_ms:.3f} ms '
          f'({b_by}: {2 * flops / 1e9:.1f} GFLOP at 67 TFLOP/s, '
          f'{100 * 2 * b_ms / (enc_ms + dec_ms):.1f}% of the rate); plain (one F.conv2d a '
          f'(image, plane), the parent\'s path) {enc_plain_ms:.3f} + {dec_plain_ms:.3f} ms; one '
          f'batched F.conv2d a level {lib_ms:.3f} ms a layout; layouts equal bit for bit, B = 1 '
          f'equal to B = {B} bit for bit, the generic instance equal to the compile-time one; '
          f'vs plain max abs err {err:.3g} (rows up to {scale:.3g}; tol 2e-5 of that)',
          flush=True)


def bias_rows_only():
    """`--bias-rows-only`: phase 3's bias-row check and times alone, on the
    trained AE's symbols of phase 3's images; prints its line and a JSON
    line."""
    import torch
    from imgcomp_cvpr_tpu_torch import weights as weights_lib
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
    from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib
    dev = torch.device('cuda')
    logs = build.build_all()
    if logs.get('bias_rows'):
        print('[bias rows build] ' + ' | '.join(
            f'{fn} {regs}' for fn, regs in ptxas_kernels(logs['bias_rows']).items()), flush=True)
    ae_config, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc_config, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    ae = ae_lib.CVPRAutoencoder(ae_config, device=dev)
    pc = pc_lib.ProbClassifier(pc_config, ae_config.num_centers, device=dev)
    ae, pc = weights_lib.load_trained(ASSET, ae, pc, device=dev)
    x = torch.from_numpy(natural_images(np.random.RandomState(0), BATCH, IMG_H, IMG_W)).to(dev)
    with torch.no_grad():
        syms = ae.encode(x).symbols.permute(0, 3, 1, 2).contiguous()
    pc5_config, _ = config_lib.parse_spec('base', 'pc')
    pc5 = pc_lib.init_params(pc_lib.ProbClassifier(pc5_config, ae_config.num_centers,
                                                   device=dev), seed=0)
    rows = {}
    bias_rows_kernel(dev, syms, ae.encoder.centers.detach(), pc5, pc5_config, rows)
    r = rows['bias_rows']
    r['bound_ms'], r['bound_by'] = r.pop('bound')
    print(json.dumps({'device': torch.cuda.get_device_name(0), 'bias_rows': r}), flush=True)
    return 0


def quantize_bwd_kernel(dev, trained_centers, rows):
    """Phase 3 for kernel 7 at the training latent (30, 20, 20, 32), L = 6:
    against its plain version on the card and in float64, with the trained
    centers and centers at init, with and without qhard's cotangent, at a
    length that is no multiple of the block, and two launches bit-equal."""
    import torch
    from imgcomp_cvpr_tpu_torch.models import quantizer as quantizer_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import quantize as qk
    shape = (TRAIN_BATCH, TRAIN_CROP // 8, TRAIN_CROP // 8, 32)
    rng = np.random.RandomState(7)
    x, g, gh = (torch.from_numpy(rng.randn(*shape).astype(np.float32) * s).to(dev)
                for s in (1.5, 1.0, 1.0))
    init_centers = quantizer_lib.init_centers(torch.Generator().manual_seed(0), 6,
                                              (-2, 2)).to(dev)
    n = x.numel()
    dx_tol, dc_tol = 1e-5, 2e-5
    worst_dx = worst_dx_rel = worst_dc = worst_dc_rel = 0.0
    for centers in (trained_centers, init_centers):
        for gh_i in (gh, None):
            for cut in (n, n - 77):
                xs, gs = x.reshape(-1)[:cut], g.reshape(-1)[:cut]
                ghs = None if gh_i is None else gh_i.reshape(-1)[:cut]
                dx, dc = qk.quantize_bwd(xs, centers, gs, ghs)
                dx2, dc2 = qk.quantize_bwd(xs, centers, gs, ghs)
                torch.cuda.synchronize()
                if not (torch.equal(dc, dc2) and torch.equal(dx, dx2)):
                    raise AssertionError('quantize_bwd: two launches differ')
                px, pc_ = qk.quantize_bwd_plain(xs, centers, gs, ghs)
                rx, rc = qk.quantize_bwd_plain(
                    xs.double(), centers.double(), gs.double(),
                    None if ghs is None else ghs.double())
                top = max(1.0, rx.abs().max().item())
                e_dx = max((dx - px).abs().max().item(), (dx.double() - rx).abs().max().item())
                dc_errs = torch.maximum((dc.double() - rc).abs(), (dc - pc_).abs().double())
                e_dc = dc_errs.max().item()
                if e_dx > dx_tol * top or e_dc > dc_tol * cut ** 0.5:
                    raise AssertionError(f'quantize_bwd: dx err {e_dx} (top {top}), '
                                         f'dcenters err {e_dc} at n={cut}')
                worst_dx, worst_dx_rel = max(worst_dx, e_dx), max(worst_dx_rel, e_dx / top)
                worst_dc = max(worst_dc, e_dc)
                worst_dc_rel = max(worst_dc_rel, (dc_errs / rc.abs()).max().item())
    # The main path hands the kernel qsoft's cotangent only (nothing in the
    # loss reads qhard): 12 bytes move per element, 16 with gh.
    flops = 33 * 6 * n        # ~25 flops and one expf (counted as 8) per center
    qt = quantizer_times(lambda: qk.quantize_bwd(x, trained_centers, g, None), 'quantize_bwd')
    qt_gh = quantizer_times(lambda: qk.quantize_bwd(x, trained_centers, g, gh), 'quantize_bwd')
    ms_main, ms_gh = (t['device_ms'] or t['graph_ms'] for t in (qt, qt_gh))
    rows['quantize_bwd'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/quantize_bwd.cu',
        replaces='imgcomp_cvpr_tpu/ops/pallas/quantize.py:193',
        max_abs_err=worst_dx, ms=ms_main, quantizer=qt,
        plain_ms=cuda_ms(lambda: qk.quantize_bwd_plain(x, trained_centers, g, None), 5),
        bound=bound(12 * n, flops), library_ms=None)
    print(f'[3 quantize_bwd] x {shape}, L=6, trained and init centers, gh present and '
          f'absent, n and n-77: dx max abs err {worst_dx:.3g} (max rel to the largest '
          f'|dx| {worst_dx_rel:.3g}, tol {dx_tol}), dcenters max abs err {worst_dc:.3g} '
          f'(max rel {worst_dc_rel:.3g}; tol {dc_tol} * sqrt(n) abs on sums of n terms) '
          f'vs plain f32 and plain f64; two '
          f'launches bit-equal; device {ms_main * 1e3:.2f} us without gh (bound '
          f'{bound(12 * n, flops)[0] * 1e3:.2f} us), {ms_gh * 1e3:.2f} us with gh '
          f'(bound {bound(16 * n, flops)[0] * 1e3:.2f} us), L2-resident inputs; '
          + quantizer_line('without gh', qt, bound(12 * n, flops)[0]), flush=True)


def training_path(dev, rows):
    """Phase 6: the training path through Trainer and train_loop.train at
    full width. Adds kernel 1's row at the training shape to ``rows`` and
    returns the launch counts of the 20-step run and 6b's ms a step."""
    import tempfile
    import torch
    from imgcomp_cvpr_tpu_torch.data import pipeline as pipeline_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build, quantize as qk
    from imgcomp_cvpr_tpu_torch.training import checkpoint as checkpoint_lib
    from imgcomp_cvpr_tpu_torch.training import train_loop
    from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib
    from imgcomp_cvpr_tpu_torch.utils import logdir as logdir_lib
    from imgcomp_cvpr_tpu_torch.utils import registry as registry_lib
    import val_torch

    ae_config, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc_config, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    if (ae_config.batch_size, tuple(ae_config.crop_size)) != (TRAIN_BATCH,
                                                              (TRAIN_CROP, TRAIN_CROP)):
        raise AssertionError('cvpr/low is not B=30 at 160x160')
    ip = pipeline_lib.InputPipeline(pipeline_lib.get_dataset('synthetic:64'),
                                    ae_config.crop_size, TRAIN_BATCH,
                                    num_preprocess_threads=1, seed=0).start()
    try:
        batch = torch.from_numpy(ip.get_batch()).to(dev)
    finally:
        ip.stop()
    # ImageNet's image count (the default): the schedule stays at lr_initial.
    trainer = trainer_lib.Trainer(ae_config, pc_config, device=dev)

    # (a) one backward through kernel 7, one through its plain version.
    state = trainer.init_state(0)
    snapshot = {k: v.clone() for k, v in state.ae.state_dict().items()}

    # Kernel 1 on the z that the training forward hands it (train-mode
    # BatchNorm, heatmap-masked, in the encoder's own memory layout).
    with torch.no_grad():
        enc, _ = state.ae(batch.to(torch.float32), True)
    z, centers = enc.z, state.ae.encoder.centers.detach()
    if tuple(z.shape) != (TRAIN_BATCH, TRAIN_CROP // 8, TRAIN_CROP // 8,
                          ae_config.num_chan_bn):
        raise AssertionError(f'6a: training z is {tuple(z.shape)}')
    qs_k, qh_k, sym_k = qk.quantize_fwd(z, centers)
    qs_p, qh_p, sym_p = qk.quantize_plain(z, centers)
    if not (torch.equal(sym_k, sym_p) and torch.equal(qh_k, qh_p)
            and torch.equal(sym_k, enc.symbols) and torch.equal(qh_k, enc.qhard)):
        raise AssertionError('6a: quantize at the training shape: symbols or qhard '
                             'differ from the plain version')
    q_err = (qs_k - qs_p).abs().max().item()
    if q_err > 1e-5:
        raise AssertionError(f'6a: quantize at the training shape: qsoft max abs err {q_err}')
    nz = z.numel()
    qt = quantizer_times(lambda: qk.quantize_fwd(z, centers), 'quantize_fwd')
    rows['quantize_train'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/quantize.cu',
        replaces='imgcomp_cvpr_tpu/ops/pallas/quantize.py:147',
        max_abs_err=q_err, ms=qt['device_ms'] or qt['graph_ms'], quantizer=qt,
        plain_ms=cuda_ms(lambda: qk.quantize_plain(z, centers), 5),
        bound=bound(16 * nz, 9 * 6 * nz), library_ms=None)
    print(f'[6a quantize at the training shape] z {tuple(z.shape)} from the train-mode '
          f'encoder at init (strides {tuple(z.stride())}, contiguous: {z.is_contiguous()}; '
          f'{len(torch.unique(sym_k))} of {centers.numel()} symbols occur): symbols and '
          f'qhard equal to the plain version and to the forward\'s own, qsoft max abs err '
          f'{q_err:.3g} (tol 1e-5); '
          + quantizer_line('times', qt, bound(16 * nz, 9 * 6 * nz)[0]), flush=True)

    def grads():
        state.ae.load_state_dict(snapshot)      # the forward moves the BN statistics
        state.optimizer.zero_grad()
        total, _ = trainer.loss_fn(state, batch)
        total.backward()
        return {n: p.grad.clone() for n, p in
                list(state.ae.named_parameters()) + list(state.pc.named_parameters())}

    def rel_diff(a, b):
        """Largest max-abs difference over the leaves, relative to the
        leaf's largest entry, and the leaf it is at."""
        rel = {n: ((a[n] - b[n]).abs().max() / b[n].abs().max()).item() for n in a}
        worst = max(rel, key=rel.get)
        return rel[worst], worst

    # cuDNN's default backward algorithms sum in an order that changes from
    # run to run; the comparison asks cuDNN for its deterministic ones, so
    # that what differs is the quantizer's backward. The default mode's own
    # run-to-run difference is printed beside it.
    before = build.LAUNCHES['quantize_bwd']
    g_default = grads(), grads()
    torch.backends.cudnn.deterministic = True
    try:
        g_kernel, g_kernel2 = grads(), grads()
        if build.LAUNCHES['quantize_bwd'] != before + 4:
            raise AssertionError('6a: the backward did not launch kernel 7')
        kernel_bwd, qk.quantize_bwd = qk.quantize_bwd, qk.quantize_bwd_plain
        try:
            g_plain = grads()
        finally:
            qk.quantize_bwd = kernel_bwd
    finally:
        torch.backends.cudnn.deterministic = False
    if build.LAUNCHES['quantize_bwd'] != before + 4:
        raise AssertionError('6a: the plain backward launched kernel 7')
    (d_plain, at), (d_rerun, _), (d_default, at_default) = (
        rel_diff(g_kernel, g_plain), rel_diff(g_kernel, g_kernel2), rel_diff(*g_default))
    print(f'[6a kernel vs plain backward] {len(g_kernel)} parameter gradients of one '
          f'forward+backward (B={TRAIN_BATCH} {TRAIN_CROP}x{TRAIN_CROP}), largest '
          f'difference relative to the leaf\'s largest entry: kernel 7 vs plain backward '
          f'{d_plain:.3g} at {at} (tol 1e-3; deterministic cuDNN algorithms, under which '
          f'two kernel runs differ by {d_rerun:.3g}); two kernel runs with cuDNN\'s '
          f'default algorithms: {d_default:.3g} at {at_default}', flush=True)
    if not all(torch.isfinite(v).all() for v in g_kernel.values()) or d_plain > 1e-3:
        raise AssertionError(f'6a: gradient rel diff {d_plain} at {at}')
    if g_kernel['encoder.h1.weight'].abs().max().item() == 0:
        raise AssertionError('6a: no gradient reaches the encoder')

    # (b) 20 train steps on the one batch, twice from the same seed.
    def run():
        state = trainer.init_state(0)
        before = {n: v.clone() for n, v in list(state.ae.state_dict().items())
                  + list(state.pc.state_dict().items())}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall = time.time()
        history = []
        for _ in range(TRAIN_STEPS):
            state, comps = trainer.train_step(state, batch)
            history.append(comps)
        torch.cuda.synchronize()
        wall = time.time() - wall
        peak = torch.cuda.max_memory_allocated()
        history = [{k: float(v) for k, v in c.items()} for c in history]
        return state, before, history, wall, peak

    torch.cuda.synchronize()
    build.reset_launches()
    state, before, hist, wall_cold, _ = run()
    eval_out = {k: float(v) for k, v in trainer.eval_step(state, batch).items()}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    want_keys = {'total_loss', 'd_loss_scaled', 'pc_loss', 'H_real', 'H_mask', 'H_soft',
                 'reg_ae', 'reg_centers', 'reg_pc', 'mse', 'psnr', 'ms_ssim', 'bpp'}
    if set(hist[0]) != want_keys:
        raise AssertionError(f'6b: comps keys {sorted(hist[0])}')
    if not all(np.isfinite(v) for c in hist for v in c.values()):
        raise AssertionError('6b: a comps value is not finite')
    if not hist[-1]['total_loss'] < hist[0]['total_loss']:
        raise AssertionError(f"6b: loss {hist[0]['total_loss']} -> {hist[-1]['total_loss']}")
    after = dict(list(state.ae.state_dict().items()) + list(state.pc.state_dict().items()))
    unmoved = [n for n in before if torch.equal(before[n], after[n])]
    if unmoved or state.step != TRAIN_STEPS:
        raise AssertionError(f'6b: step {state.step}, unmoved {unmoved}')
    if not all(np.isfinite(v) for v in eval_out.values()) or not eval_out['bpp'] > 0:
        raise AssertionError(f'6b: eval_step {eval_out}')
    # the first step eager, the second captured in the step's CUDA graph and
    # replayed, the rest replays: kernels 1 and 7 once each a step, and
    # kernel 1 once more for eval_step
    if (launches['quantize'] != TRAIN_STEPS + 1 or launches['quantize_bwd'] != TRAIN_STEPS
            or launches['train_graph_capture'] != 1
            or launches['train_graph_replay'] != TRAIN_STEPS - 1):
        raise AssertionError(f'6b: launches {launches}')
    state2, _, hist2, wall, peak = run()
    loss_diff = max(abs(a['total_loss'] - b['total_loss']) / abs(a['total_loss'])
                    for a, b in zip(hist, hist2))
    # Any two float32 evaluations of this loss's gradient at init part by
    # ~1e-3..1e-2 of a leaf (ReLU and clip kinks within rounding of 0, seen
    # also against float64 and the CPU), and cuDNN's default backward is not
    # run-to-run reproducible, so two trajectories drift apart; measured
    # ~2e-3 in loss over 20 steps on an H100. Recorded; held to 1e-2.
    if loss_diff > 1e-2:
        raise AssertionError(f'6b: two runs from one seed differ by {loss_diff} in loss')

    # per-step split, on the warm second state
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(5)]
    for e in ev:
        e[0].record()
        state2.optimizer.zero_grad()
        total, _ = trainer.loss_fn(state2, batch)
        e[1].record()
        total.backward()
        e[2].record()
        state2.optimizer.step()
        state2.step += 1
        e[3].record()
    torch.cuda.synchronize()
    fwd, bwd, opt = (float(np.mean([e[i].elapsed_time(e[i + 1]) for e in ev]))
                     for i in range(3))
    print(f'[6b train steps] ae cvpr/low + pc cvpr/res_shallow, B={TRAIN_BATCH} '
          f'{TRAIN_CROP}x{TRAIN_CROP} (latent ({TRAIN_BATCH}, {TRAIN_CROP // 8}, '
          f'{TRAIN_CROP // 8}, {ae_config.num_chan_bn})), seed 0, {TRAIN_STEPS} steps '
          f"on one batch: total_loss {hist[0]['total_loss']:.4f} -> "
          f"{hist[-1]['total_loss']:.4f}, ms_ssim {hist[0]['ms_ssim']:.5f} -> "
          f"{hist[-1]['ms_ssim']:.5f}, bpp {hist[0]['bpp']:.5f} -> {hist[-1]['bpp']:.5f}; "
          f'every comps value finite, every parameter and BN statistic moved; eval_step '
          f"bpp {eval_out['bpp']:.5f} ms_ssim_eval {eval_out['ms_ssim_eval']:.5f} psnr "
          f"{eval_out['psnr']:.3f}; launches in the {TRAIN_STEPS} steps and the eval_step: "
          f"quantize {launches['quantize']}, quantize_bwd {launches['quantize_bwd']} (one "
          f'each a train step, eager or replayed, one quantize for eval_step), graph '
          f"captures {launches['train_graph_capture']}, "
          f"replays {launches['train_graph_replay']}; eager ms per step "
          f'(CUDA events, 5 steps): forward {fwd:.3f}, '
          f'backward {bwd:.3f}, optimizer {opt:.3f}; {TRAIN_STEPS} steps in '
          f'{wall * 1e3:.1f} ms = {TRAIN_BATCH * TRAIN_STEPS / wall:.2f} img_per_sec (first '
          f'run, cold: {TRAIN_BATCH * TRAIN_STEPS / wall_cold:.2f}); peak memory '
          f'{peak / 2 ** 20:.1f} MiB; largest rel loss diff between two runs from seed 0: '
          f'{loss_diff:.3g}', flush=True)

    # (c) the loop: train with a test interval and a save, restore, continue.
    with tempfile.TemporaryDirectory() as root:
        flags = train_loop.TrainFlags(log_interval_train=10, log_interval_test=20,
                                      log_interval_save=20, max_steps=30)
        log_dir = train_loop.train('cvpr/low', 'cvpr/res_shallow', 'synthetic:64',
                                   'synthetic:8', log_dir_root=root, flags=flags, seed=0,
                                   description='chip_smoke phase 6c', device=dev)
        ckpt_dir = logdir_lib.ckpt_dir_for_log_dir(log_dir)
        saved, itr = checkpoint_lib.Saver(ckpt_dir).restore()
        events = {name: [json.loads(line) for line in
                         open(os.path.join(log_dir, f'events_{name}.jsonl'))]
                  for name in ('train', 'test')}
        # d_BPG is NaN: there are no BPG curves ('testset', the default)
        if (itr != 30 or saved['step'] != 30
                or [e['step'] for e in events['train']] != [10, 20, 30]
                or [e['step'] for e in events['test']] != [20]
                or not np.isnan(events['test'][0].pop('d_BPG'))
                or not all(np.isfinite(v) for e in events['train'] + events['test']
                           for v in e.values())):
            raise AssertionError(f'6c: itr {itr}, events {events}')
        dumps = sorted(os.listdir(os.path.join(log_dir, 'imgs')))
        if dumps != [f'00000020_{i}_{k}.png' for i in range(3) for k in ('hm', 'in', 'out')]:
            raise AssertionError(f'6c: image dumps {dumps}')
        runs = registry_lib.read_runs(root)
        if [r['description'] for r in runs] != ['chip_smoke phase 6c']:
            raise AssertionError(f'6c: registry {runs}')
        # Restore into a differently seeded state: it continues at 30 with
        # the saved parameters, statistics and optimizer moments.
        fresh = trainer_lib.Trainer(ae_config, pc_config, num_train_images=64,
                                    device=dev).init_state(99)
        rm = checkpoint_lib.RestoreManager(ckpt_dir, continue_in_ckpt_dir=True)
        fresh, at = rm.restore(fresh)
        a = checkpoint_lib.flatten(saved)
        b = checkpoint_lib.flatten(fresh.state_dict())
        tensors = [k for k in a if isinstance(a[k], torch.Tensor)]
        if at != 30 or set(a) != set(b) or not all(torch.equal(a[k], b[k].cpu())
                                                   for k in tensors):
            raise AssertionError('6c: the restored state differs from the checkpoint')
        flags = train_loop.TrainFlags(log_interval_train=2, log_interval_test=-1,
                                      log_interval_save=1000, max_steps=34)
        log_dir2 = train_loop.train('cvpr/low', 'cvpr/res_shallow', 'synthetic:64',
                                    'synthetic:8', log_dir_root=root, restore_manager=rm,
                                    flags=flags, seed=0, device=dev)
        steps = [json.loads(line)['step']
                 for line in open(os.path.join(log_dir, 'events_train.jsonl'))]
        final, itr2 = checkpoint_lib.Saver(ckpt_dir).restore()
        if log_dir2 != log_dir or steps != [10, 20, 30, 32, 34] or itr2 != 34:
            raise AssertionError(f'6c: continued run: steps {steps}, ckpt {itr2}')
        # what training wrote, validation reads: the last checkpoint, 8 images
        job = logdir_lib.log_date_from_log_dir(log_dir)
        val_log = os.path.join(root, 'validate.log')
        with open(val_log, 'w') as f, contextlib.redirect_stdout(f):
            val_torch.main([root, job, NATKODAK, '--how_many', '8', '-s', '-1',
                           '--device', dev.type])
        out_dir = os.path.join(root, f'{job} natkodak24')
        rows = open(os.path.join(out_dir, 'measures.csv')).read().splitlines()[1:]
        summary = json.load(open(os.path.join(out_dir, 'summary_34.json')))
        if len(rows) != 8 or not np.isfinite([summary[k] for k in ('bpp', 'ms-ssim', 'psnr')]).all():
            raise AssertionError(f'6c: validation of the trained run: {rows}, {summary}')
        print(f'[6c train loop] train_loop.train cvpr/low + cvpr/res_shallow on '
              f'synthetic:64 / synthetic:8: 30 steps, train logs at 10/20/30 (img_per_sec '
              f"{events['train'][-1]['img_per_sec']:.2f} with the host pipeline, total_loss "
              f"{events['train'][0]['total_loss']:.2f} -> {events['train'][-1]['total_loss']:.2f}"
              f' on changing batches), test at 20 (bpp '
              f"{events['test'][0]['bpp']:.5f}), checkpoints at 20 and 30; restored at 30 "
              f'with {len(tensors)} tensors equal to the checkpoint, continued to 34 in the '
              f'same log dir; test images dumped at 20 ({len(dumps)} PNGs), d_BPG NaN (no BPG '
              f'curves), the description in the run registry; val_torch.py on the run\'s '
              f'last checkpoint (34), 8 natkodak24 images: bpp {summary["bpp"]:.5f} ms-ssim '
              f'{summary["ms-ssim"]:.5f} psnr {summary["psnr"]:.3f}', flush=True)
    return launches, fwd + bwd + opt


def validation_path(dev):
    """Phase 7: the validation path at full width. The trained ae cvpr/low +
    pc cvpr/res_shallow, saved as a checkpoint through the Saver and the tree
    layout that train_loop.train writes, validated on the 24 natkodak24
    images (512x768, eval batch 8: three full buckets) without and with
    real_bpp; the pad_batch_to check (--how_many 5: one bucket of 5 padded to
    8); a short K != 3 run (seeded pc base) through kernels 5 and 6. Returns
    the launch counts of the real-bpp sweeps (K=3 and K=5 merged by name)."""
    import torch
    from PIL import Image
    from imgcomp_cvpr_tpu_torch import weights as weights_lib
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib
    from imgcomp_cvpr_tpu_torch.coding import cuda_codec
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
    from imgcomp_cvpr_tpu_torch.data import val_images
    from imgcomp_cvpr_tpu_torch.data.images_iterator import ImagesIterator
    from imgcomp_cvpr_tpu_torch.eval import validate as validate_lib
    from imgcomp_cvpr_tpu_torch.eval.val_files import ValidationDirs
    from imgcomp_cvpr_tpu_torch.ops.kernels import build, quantize as qk
    from imgcomp_cvpr_tpu_torch.training import checkpoint as checkpoint_lib
    from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib
    from imgcomp_cvpr_tpu_torch.utils import logdir as logdir_lib
    import val_torch

    t_phase = time.time()
    shutil.rmtree(VAL_ROOT, ignore_errors=True)
    os.makedirs(VAL_ROOT)
    log = open(os.path.join(VAL_ROOT, 'validate.log'), 'w')   # validate's own lines

    def checkpoint(ae_spec, pc_spec, load_pc):
        """A log dir named for the configs, holding the trained AE (and the
        trained context model, or a seeded one) as checkpoint 9000."""
        ae_config, ae_rel = config_lib.parse_spec(ae_spec, 'ae')
        pc_config, pc_rel = config_lib.parse_spec(pc_spec, 'pc')
        state = trainer_lib.Trainer(ae_config, pc_config, device=dev).init_state(0)
        tree = weights_lib.load_npz(ASSET)
        state.ae.load_state_dict(weights_lib.ae_state_dict(
            tree['params']['ae'], tree['batch_stats'], state.ae))
        if load_pc:
            state.pc.load_state_dict(weights_lib.pc_state_dict(tree['params']['pc']))
        log_dir = logdir_lib.create_unique_log_dir([ae_rel, pc_rel], VAL_ROOT)
        checkpoint_lib.Saver(logdir_lib.ckpt_dir_for_log_dir(log_dir)).save(
            state.state_dict(), 9000)
        return log_dir, state

    log_dir, state = checkpoint('cvpr/low', 'cvpr/res_shallow', load_pc=True)
    ckpt_dir, job = logdir_lib.ckpt_dir_for_log_dir(log_dir), logdir_lib.log_date_from_log_dir(log_dir)
    paths, name = val_images.get_image_paths(NATKODAK)
    if len(paths) != VAL_IMAGES or name != 'natkodak24':
        raise AssertionError(f'7: {len(paths)} images, dataset name {name}')
    images = ImagesIterator(paths, name)

    # Kernel 1 on the eval z of the first bucket.
    x = torch.from_numpy(np.stack([a for _, a in itertools.islice(images.iter_imgs(pad=8),
                                                                  VAL_BATCH)])).to(dev)
    if tuple(x.shape) != (VAL_BATCH, IMG_H, IMG_W, 3):
        raise AssertionError(f'7: first bucket {tuple(x.shape)}')
    with torch.no_grad():
        enc = state.ae.encode(x.to(torch.float32))
    z, centers = enc.z.contiguous(), state.ae.encoder.centers.detach()
    qs_k, qh_k, sym_k = qk.quantize_fwd(z, centers)
    qs_p, qh_p, sym_p = qk.quantize_plain(z, centers)
    q_err = (qs_k - qs_p).abs().max().item()
    if not (torch.equal(sym_k, sym_p) and torch.equal(qh_k, qh_p)
            and torch.equal(sym_k, enc.symbols)) or q_err > 1e-5:
        raise AssertionError(f'7: kernel 1 on the eval z differs from its plain version '
                             f'(qsoft max abs err {q_err})')
    print(f'[7 quantize on the eval z] z {tuple(z.shape)} of the first bucket (8 natkodak24 '
          f'images): symbols and qhard equal to the plain version and to the encoder\'s own, '
          f'qsoft max abs err {q_err:.3g} (tol 1e-5)', flush=True)

    em = validate_lib.build_eval_model_from_log_dir(log_dir, device=dev)
    em.set_params(state.state_dict()['model'])
    imgs8 = list(x.cpu().numpy())
    first = em.fetch_many(imgs8, pad_batch_to=VAL_BATCH)    # warm-up, untimed

    # Kernels 2 and 3 at the sweep's B=8, on the symbols validate hands the
    # codec for the first bucket: kernel 2's encode tables against its plain
    # version, kernel 3's words, counts, states and tail lengths against its
    # plain version byte for byte. The sweep's bit-exact round trip then
    # holds the scan decode at B=8 (its cluster size is chosen by B).
    syms8 = torch.from_numpy(np.stack([o['sym'] for o in first])).to(dev)
    syms8 = syms8.permute(0, 3, 1, 2).contiguous()              # (B, C, H, W)
    shape = tuple(syms8.shape[1:])
    held = hold_coder(7, 'the first bucket\'s symbols', em.pc, em.pc_config,
                      em.ae.encoder.centers, syms8, dev)
    sched8 = ck.build_schedule(shape)
    with torch.no_grad():
        fw = cuda_codec.fold_weights(em.pc, em.ae.encoder.centers)
    print(f'[7 kernels 2 and 3 at B={VAL_BATCH}] {held}; the scan at B={VAL_BATCH} takes '
          f'clusters of {ck.scan_cluster(fw.w2.shape[-1], fw.w4.shape[-1], sched8.CQ, sched8.T, VAL_BATCH)} '
          f'blocks, held by the sweep\'s round trips', flush=True)
    lc = codec_lib.LatentCodec(em.pc, em.pc_config, device=dev)
    ms = {'fetch': [], 'codec': []}
    bits, streams = [], []

    def timed(fn, key):
        def run(*args, **kwargs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args, **kwargs)
            ev[1].record()
            ms[key].append(ev)
            if fn.__name__ == 'encode_batch':
                bits.extend((r.num_bits, r.theoretical_bits) for r in out)
                streams.extend(r.bitstream for r in out)
            return out
        return run

    em.fetch_many = timed(em.fetch_many, 'fetch')
    lc.encode_batch = timed(lc.encode_batch, 'codec')
    lc.decode_batch = timed(lc.decode_batch, 'codec')

    def sweep(real_bpp):
        for v in ms.values():
            v.clear()
        bits.clear()
        streams.clear()
        flags = validate_lib.OutputFlags(save_ours=real_bpp, ckpt_step=-1, real_bpp=real_bpp,
                                         eval_batch=VAL_BATCH)
        torch.cuda.synchronize()
        build.reset_launches()
        wall = time.time()
        with contextlib.redirect_stdout(log):
            vd = ValidationDirs(ckpt_dir, VAL_ROOT, name, reset=True)
            validate_lib.validate(vd, images, flags, eval_model=em, codec=lc)
        torch.cuda.synchronize()
        wall = time.time() - wall
        launches = dict(build.LAUNCHES)
        t = {k: sum(e[0].elapsed_time(e[1]) for e in v) for k, v in ms.items()}
        rows = open(os.path.join(vd.out_dir, 'measures.csv')).read().splitlines()
        summary = json.load(open(os.path.join(vd.out_dir, 'summary_9000.json')))
        if len(rows) != VAL_IMAGES + 1 or len(ms['fetch']) != VAL_IMAGES // VAL_BATCH:
            raise AssertionError(f'7: {len(rows) - 1} measures rows, '
                                 f'{len(ms["fetch"])} fetch_many calls')
        return vd, rows, summary, t, wall, launches

    _, rows_a, sum_a, t_a, wall_a, _ = sweep(real_bpp=False)
    vd, rows, summary, t_b, wall_b, launches = sweep(real_bpp=True)
    if rows != rows_a:
        raise AssertionError('7: the measures of the real-bpp sweep differ')
    for k in ('quantize', 'wavefront_forward_encode', 'rans_reverse', 'wavefront_forward_decode'):
        if launches[k] < VAL_IMAGES // VAL_BATCH:
            raise AssertionError(f'7: {k} launched {launches[k]} times in the real-bpp sweep')
    n_px = VAL_IMAGES * IMG_H * IMG_W
    real, theory = (sum(b[i] for b in bits) / n_px for i in (0, 1))
    overhead = 100 * (real / theory - 1)
    if len(bits) != VAL_IMAGES or not overhead <= OVERHEAD_LIMIT_PCT:
        raise AssertionError(f'7: {len(bits)} coded images, real/theory overhead {overhead}%')
    saved = sorted(os.listdir(os.path.join(vd.out_dir, 'imgs')))
    if saved != [os.path.basename(p) for p in paths]:
        raise AssertionError(f'7: --save_ours wrote {saved}')
    for f in saved:
        with Image.open(os.path.join(vd.out_dir, 'imgs', f)) as im:
            if im.size != (IMG_W, IMG_H):
                raise AssertionError(f'7: saved {f} is {im.size}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f'[7 validation] trained ae cvpr/low + pc cvpr/res_shallow from checkpoint 9000 '
          f'(train_loop\'s tree), {VAL_IMAGES} natkodak24 images {IMG_H}x{IMG_W}, eval batch '
          f'{VAL_BATCH}: bpp {summary["bpp"]:.5f}, ms-ssim {summary["ms-ssim"]:.5f}, psnr '
          f'{summary["psnr"]:.3f} dB; real / theoretical / loss bpp {real:.5f} / {theory:.5f} / '
          f'{summary["bpp"]:.5f}, real/theory overhead {overhead:.4f}% (limit '
          f'{OVERHEAD_LIMIT_PCT}%); every '
          f'bucket\'s round trip CRC-verified bit-exact; launches in the real-bpp sweep: '
          f'{ {k: v for k, v in launches.items() if v} }; {VAL_IMAGES} PNGs of {IMG_W}x{IMG_H} '
          f'saved', flush=True)
    print(f'[7 validation speed] {smi}: fetch_many (AE encode + decode, bitcost, metrics, '
          f'to host; CUDA events) {t_a["fetch"]:.1f} ms for {VAL_IMAGES} images = '
          f'{VAL_IMAGES / t_a["fetch"] * 1e3:.3f} img/s without real_bpp (sweep wall '
          f'{wall_a:.2f} s); with real_bpp fetch_many {t_b["fetch"]:.1f} ms + codec '
          f'(encode_batch + decode_batch, 3 buckets) {t_b["codec"]:.1f} ms = '
          f'{VAL_IMAGES / (t_b["fetch"] + t_b["codec"]) * 1e3:.3f} img/s (sweep wall '
          f'{wall_b:.2f} s, saving the PNGs included)', flush=True)

    # Where a bucket's fetch_many goes: one call on the first bucket under
    # torch.profiler, its device time by the ic.val.<step> spans of
    # eval/validate.py (CUPTI kernel records under each range).
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    ms['fetch'].clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        em.fetch_many(imgs8, pad_batch_to=VAL_BATCH)
        torch.cuda.synchronize()
    traced_ms = ms['fetch'][0][0].elapsed_time(ms['fetch'][0][1])
    split = {}
    for e in prof.events():
        if e.name.startswith('ic.val.') and e.device_type == DeviceType.CPU:
            split[e.name[7:]] = split.get(e.name[7:], 0.0) + e.device_time_total / 1e3
    split_txt = ({k: round(v, 3) for k, v in split.items()} if sum(split.values()) > 0
                 else 'not recorded (the profiler saw no device time)')
    print(f'[7 fetch_many split] one bucket of {VAL_BATCH} at {IMG_H}x{IMG_W}: device ms by '
          f'step (torch.profiler, ic.val.<step> spans) {split_txt}, sum '
          f'{sum(split.values()):.1f}; the traced call {traced_ms:.1f} ms (CUDA events, '
          f'profiler on)', flush=True)

    # pad_batch_to: 5 images, one bucket padded to 8, through val_torch.py
    with contextlib.redirect_stdout(log):
        val_torch.main([VAL_ROOT, job, NATKODAK, '--how_many', '5', '--reset', '-s', '-1',
                        '--device', dev.type])
    rows5 = open(os.path.join(vd.out_dir, 'measures.csv')).read().splitlines()
    if rows5 != rows[:6]:
        raise AssertionError(f'7: --how_many 5 measures {rows5[1:]} differ from the full '
                             f'sweep\'s first five {rows[1:6]}')

    # K != 3: the trained AE with a seeded pc base, 4 images, real bpp.
    log5, state5 = checkpoint('cvpr/low', 'base', load_pc=False)
    job5 = logdir_lib.log_date_from_log_dir(log5)
    torch.cuda.synchronize()
    build.reset_launches()
    with contextlib.redirect_stdout(log):
        val_torch.main([VAL_ROOT, job5, NATKODAK, '--how_many', '4', '--real_bpp', '-s', '-1',
                        '--device', dev.type])
    torch.cuda.synchronize()
    launches5 = dict(build.LAUNCHES)
    for k in ('quantize', 'plane_forward_encode', 'plane_reverse', 'plane_forward_decode'):
        if launches5[k] < 1:
            raise AssertionError(f'7: {k} was not launched in the K=5 real-bpp run')
    summary5 = json.load(open(os.path.join(VAL_ROOT, f'{job5} natkodak24', 'summary_9000.json')))

    # Kernels 5 and 6 on the K=5 run's 4 images (the first bucket's first
    # four: one shape, so the same symbols) against their plain versions.
    pc5_config, _ = config_lib.parse_spec('base', 'pc')
    held5 = hold_coder(7, 'the K=5 run\'s 4 images', state5.pc, pc5_config,
                       em.ae.encoder.centers, syms8[:4], dev)
    print(f'[7 validation, K=5] trained ae cvpr/low + seeded pc base (K=5), --how_many 4 '
          f'--real_bpp through val_torch.py: round trips CRC-verified bit-exact; bpp '
          f'{summary5["bpp"]:.5f} (a seeded context model: this bpp describes no trained '
          f'codec), launches { {k: v for k, v in launches5.items() if v} }; {held5}; '
          f'--how_many 5 '
          f'(one bucket of 5 padded to 8): measures equal to the full sweep\'s first five, '
          f'exactly', flush=True)
    log.close()
    print(f'[7 phase time] {time.time() - t_phase:.1f} s', flush=True)
    merged = dict(launches)
    merged.update({k: v for k, v in launches5.items() if k.startswith('plane')})
    rows_k5 = open(os.path.join(VAL_ROOT, f'{job5} natkodak24',
                                'measures.csv')).read().splitlines()
    return merged, {'rows': rows, 'log5': log5, 'log_dir': log_dir, 'streams': list(streams),
                    'rows_k5': rows_k5}


def hold_coder(phase, label, pc, pc_config, centers, syms, dev):
    """Hold a codec's encode-side kernels to their plain versions on the
    symbols (B, C, H, W) int8 that a tool hands the codec: for K=3 kernel
    2's encode tables and kernel 3's words / counts / states / tail
    lengths, for any other K kernel 5's tables and kernel 6's outputs.
    Tables within phase 3's flip tolerance, the reverse encoders byte for
    byte. Raises naming the phase. Returns one line of text."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import cuda_codec, planar_codec
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
    from imgcomp_cvpr_tpu_torch.coding import planar_kernel as plk
    B, shape = syms.shape[0], tuple(syms.shape[1:])
    n = int(np.prod(shape))
    with torch.no_grad():
        if pc_config.kernel_size == 3:
            flat = syms.reshape(B, n).int().contiguous()
            fw = cuda_codec.fold_weights(pc, centers)
            f_k, s_k = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=flat)
            enc_ms, (f_p, s_p) = host_ms(lambda: ck.wavefront_encode_plain(fw, shape, flat))
            act = torch.from_numpy(ck.build_schedule(shape).idx_cm < n).to(dev)
            flips = int((((f_k != f_p) | (s_k != s_p)) & act).sum().item())
            entries = int(act.sum().item()) * B
            rev_k = ck.rans_reverse(f_k, s_k, shape, 1)
            rev_ms, rev_p = host_ms(lambda: ck.rans_reverse_plain(f_k, s_k, shape, 1))
            names = 'kernel 2\'s encode tables', 'kernel 3'
        else:
            coder = planar_codec.PlanarCoder(pc, pc_config, device=dev)
            sched, fold = coder._prepare(shape, centers)
            f_k, s_k = coder.encode_tables(syms.int().contiguous(), fold)
            enc_ms, (f_p, s_p) = host_ms(lambda: coder.encode_tables(
                syms.int().contiguous(), fold, plain=True))
            flips = int(((f_k != f_p) | (s_k != s_p)).sum().item())
            entries = int((sched.idx_cm < shape[1] * shape[2]).sum()) * B * shape[0]
            rev_k = plk.plane_reverse(f_k, s_k, shape, coder.K, 1)
            rev_ms, rev_p = host_ms(lambda: plk.plane_reverse_plain(f_k, s_k, shape, coder.K, 1))
            names = 'kernel 5\'s encode tables', 'kernel 6'
    if flips > 1e-3 * entries:      # phase 3's tolerance for this comparison
        raise AssertionError(f'{phase}: {label}: {names[0]}: {flips} flips > 0.1% of '
                             f'{entries}')
    if not same_reverse(rev_k, rev_p, [(i, i) for i in range(B)]):
        raise AssertionError(f'{phase}: {label}: {names[1]} differs from its plain version')
    return (f'{label} {tuple(syms.shape)}: {names[0]} vs the plain version '
            f'({enc_ms / 1e3:.1f} s) {flips} flips of {entries} active entries (tol 0.1%), '
            f'{names[1]} byte-equal to the plain version ({rev_ms / 1e3:.1f} s, '
            f'{int(rev_k[1].sum().item())} words)')


def tools_path(dev, val_info):
    """Phase 8: the tools at full width on the card. codec_cli's three modes
    with the trained npz on 3 natkodak24 images and a 509x765 crop (every
    file CRC-verified, decoded twice to the same pixels), and --log_dir on
    phase 7's K=5 checkpoint; profile_codec at B=8; ab_streams dump twice,
    compare and cross for both codecs; parity_check on a TF1 checkpoint that
    the port's pure exporter writes from the trained npz, against phase 7's
    numbers for 8 images (PASS) and at 1.2x their bpp (FAIL). Then, with
    the phase's launch counts read, each kernel against its plain version
    on the phase's own inputs: kernel 1 on the B=1 eval z of one image (K=3)
    and of the --log_dir image (K=5), kernels 2 and 3 on the first one's
    B=1 symbols, kernels 5 and 6 on the second's, and both codecs' encode
    side on ab_streams' B=8 symbols. Returns the launch counts of the
    tools' runs."""
    import io
    import torch
    from PIL import Image
    from imgcomp_cvpr_tpu_torch import weights as weights_lib
    from imgcomp_cvpr_tpu_torch.ops import metrics as metrics_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    from imgcomp_cvpr_tpu_torch.tools import ab_streams, codec_cli, parity_check
    from imgcomp_cvpr_tpu_torch.tools import profile_codec, tf1_import
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib

    t_phase = time.time()
    shutil.rmtree(TOOLS_ROOT, ignore_errors=True)
    os.makedirs(TOOLS_ROOT)
    names = sorted(os.listdir(NATKODAK))
    pngs = [os.path.join(NATKODAK, n) for n in names[:3]]
    with Image.open(pngs[0]) as im:
        crop = np.asarray(im.convert('RGB'))[1:510, 2:767]          # 509 x 765
    pngs.append(os.path.join(TOOLS_ROOT, 'crop509x765.png'))
    Image.fromarray(crop).save(pngs[-1])
    torch.cuda.synchronize()
    build.reset_launches()

    def synced_ms(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    def quiet(fn, *args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
        return out, buf.getvalue().strip()

    model = codec_cli.load_model(npz=ASSET, device=dev)
    model.compress(np.asarray(Image.open(pngs[0]).convert('RGB')))      # warm-up
    for png in pngs:
        stem = os.path.join(TOOLS_ROOT, os.path.basename(png)[:-4])
        img = np.asarray(Image.open(png).convert('RGB'))
        args = ['--npz', ASSET, '--device', dev.type]
        t_main = {}
        for mode, src, dst in (('compress', png, stem + '.icz'),
                               ('decompress', stem + '.icz', stem + '_out.png'),
                               ('roundtrip', png, stem + '_rt.icz')):
            t_main[mode], (_, said) = synced_ms(quiet, codec_cli.main, [mode, src, '-o', dst] + args)
        blob = open(stem + '.icz', 'rb').read()
        c_ms, again = synced_ms(model.compress, img)
        d_ms, out = synced_ms(model.decompress, blob)
        out2 = model.decompress(blob)
        written = np.asarray(Image.open(stem + '_out.png'))
        if again != blob or open(stem + '_rt.icz', 'rb').read() != blob:
            raise AssertionError(f'8: {png}: compress gave other bytes on a second run')
        if not (np.array_equal(out, out2) and np.array_equal(out, written)) or out.shape != img.shape:
            raise AssertionError(f'8: {png}: two decompressions of one file differ')
        psnr = metrics_lib.psnr_np(img, out)
        if not psnr > 15.0:
            raise AssertionError(f'8: {png}: PSNR {psnr:.2f} dB')
        print(f'[8 codec_cli] {os.path.basename(png)} {img.shape[0]}x{img.shape[1]}: '
              f'{len(blob)} bytes = {len(blob) * 8 / (img.shape[0] * img.shape[1]):.5f} bpp '
              f'(file, header included), PSNR {psnr:.3f} dB; decode CRC-verified, twice the '
              f'same pixels, equal to the PNG of decompress; CodecModel ms (CUDA-synced host '
              f'clock): compress {c_ms:.1f}, decompress {d_ms:.1f}; main() ms (model load and '
              f'PNG I/O included): ' + ', '.join(f'{k} {v:.1f}' for k, v in t_main.items())
              + f'; roundtrip said: {said.splitlines()[-1]}', flush=True)

    # K=5: phase 7's seeded pc base checkpoint through --log_dir (kernels 5, 6).
    n5 = {k: build.LAUNCHES[k] for k in ('plane_forward_encode', 'plane_forward_decode',
                                         'plane_reverse')}
    rt5_ms, (_, said5) = synced_ms(quiet, codec_cli.main, [
        'roundtrip', pngs[0], '-o', os.path.join(TOOLS_ROOT, 'k5.icz'),
        '--log_dir', val_info['log5'], '--device', dev.type])
    if any(build.LAUNCHES[k] <= n for k, n in n5.items()):
        raise AssertionError('8: codec_cli --log_dir (K=5) did not launch kernels 5 and 6')
    print(f'[8 codec_cli --log_dir] phase 7\'s K=5 checkpoint (seeded pc base, impl id 6): '
          f'{said5.splitlines()[-1]} ({rt5_ms:.1f} ms with the model load)', flush=True)

    report = profile_codec.profile(batch=8, device=dev)
    print(f'[8 profile_codec] {json.dumps(report)}', flush=True)

    for impl, k in (('cuda', '3'), ('cuda_planar', '5')):
        dumps = [os.path.join(TOOLS_ROOT, f'ab_{impl}_{i}.pkl') for i in range(2)]
        said = []
        for d in dumps:
            said.append(quiet(ab_streams.main, ['dump', '--impl', impl, '--k', k, '--out', d])[1])
        rc, said_c = quiet(ab_streams.main, ['compare'] + dumps)
        rc_x, said_x = quiet(ab_streams.main, ['cross', dumps[0]])
        if rc or rc_x:
            raise AssertionError(f'8: ab_streams {impl}: compare rc {rc}, cross rc {rc_x}: '
                                 f'{said_c} {said_x}')
        print(f'[8 ab_streams] impl {impl} (K={k}, shape (16, 24, 36), batch 8): '
              f'{said[0].splitlines()[-1]}; {said_c}; {said_x}', flush=True)

    # parity_check: a TF1 checkpoint of the trained npz, 8 images.
    ae_config, _ = config_lib.parse_spec('cvpr/low', 'ae')
    tree = weights_lib.load_npz(ASSET)
    prefix = tf1_import.export_tf1_checkpoint(tree['params'], tree['batch_stats'], ae_config,
                                              os.path.join(TOOLS_ROOT, 'tf1', 'ckpt-9000'))
    imgs8 = os.path.join(TOOLS_ROOT, 'imgs8')
    os.makedirs(imgs8)
    for n in names[:VAL_BATCH]:
        shutil.copy(os.path.join(NATKODAK, n), imgs8)
    rows = [r.split(',') for r in val_info['rows'][1:]]
    rows = {r[0]: r for r in rows}
    bpp7 = float(np.mean([float(rows[n][1]) for n in names[:VAL_BATCH]]))
    ms7 = float(np.mean([float(rows[n][2]) for n in names[:VAL_BATCH]]))
    common = [prefix, '--images', imgs8, '--ae', 'cvpr/low', '--pc', 'cvpr/res_shallow',
              '--device', dev.type, '--expected_msssim', repr(ms7), '--expected_bpp']
    rc_pass, said_pass = quiet(parity_check.main, common + [repr(bpp7)])
    rc_fail, said_fail = quiet(parity_check.main, common + [repr(1.2 * bpp7)])
    if rc_pass != 0 or rc_fail != 1:
        raise AssertionError(f'8: parity_check rc {rc_pass} (want 0) / {rc_fail} (want 1): '
                             f'{said_pass} | {said_fail}')
    print(f'[8 parity_check] TF1 checkpoint of the trained npz (pure exporter, '
          f'{os.path.getsize(prefix + ".data-00000-of-00001")} data bytes), {VAL_BATCH} '
          f'natkodak24 images against phase 7\'s bpp {bpp7:.6f} / MS-SSIM {ms7:.6f}: PASS '
          f'({" ".join(said_pass.splitlines()[-3:])}); at 1.2x bpp FAIL '
          f'({said_fail.splitlines()[-2]})', flush=True)

    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for k in ('quantize', 'wavefront_forward_encode', 'wavefront_forward_decode', 'rans_reverse',
              'plane_forward_encode', 'plane_forward_decode', 'plane_reverse'):
        if launches[k] < 1:
            raise AssertionError(f'8: kernel {k} was not launched by the tools')
    print(f'[8 tools] launches {dict((k, v) for k, v in launches.items() if v)}', flush=True)

    # The plain holds, on the inputs the tools handed the kernels.
    from imgcomp_cvpr_tpu_torch.data.images_iterator import add_padding
    from imgcomp_cvpr_tpu_torch.eval.validate import deterministic_cudnn
    from imgcomp_cvpr_tpu_torch.ops.kernels import quantize as qk
    model5 = codec_cli.load_model(log_dir=val_info['log5'], device=dev)
    t_holds = time.time()
    holds = []
    for m, png in ((model, pngs[0]), (model5, pngs[0])):
        padded, _ = add_padding(np.asarray(Image.open(png).convert('RGB')), codec_cli._PAD)
        x = torch.from_numpy(padded[None]).to(dev, torch.float32)
        with torch.no_grad(), deterministic_cudnn():
            enc = m.ae.encode(x)
        z, centers = enc.z.contiguous(), m.ae.encoder.centers.detach()
        qs_k, qh_k, sym_k = qk.quantize_fwd(z, centers)
        qs_p, qh_p, sym_p = qk.quantize_plain(z, centers)
        q_err = (qs_k - qs_p).abs().max().item()
        label = f'{os.path.basename(png)} K={m.pc.config.kernel_size}'
        if not (torch.equal(sym_k, sym_p) and torch.equal(qh_k, qh_p)
                and torch.equal(sym_k, enc.symbols)) or q_err > 1e-5:
            raise AssertionError(f'8: {label}: kernel 1 on the eval z differs from its plain '
                                 f'version (qsoft max abs err {q_err})')
        syms = sym_k.permute(0, 3, 1, 2).to(torch.int8).contiguous()
        holds.append(f'kernel 1 on {label}\'s z {tuple(z.shape)}: symbols and qhard equal, '
                     f'qsoft max abs err {q_err:.3g} (tol 1e-5); '
                     + hold_coder(8, f'codec_cli {label}', m.pc, m.pc.config, m._centers_dev,
                                  syms, dev))
    for impl, k in (('cuda', 3), ('cuda_planar', 5)):
        # ab_streams dump's workload at its defaults: shape, L, seed, batch
        pc, cfg, centers, rng, _ = ab_streams._build((16, 24, 36), 6, k, 0, dev.type)
        syms = torch.from_numpy(rng.randint(0, 6, size=(8, 16, 24, 36)).astype(np.int8))
        holds.append(hold_coder(8, f'ab_streams {impl}', pc, cfg,
                                torch.from_numpy(centers).to(dev), syms.to(dev), dev))
    for h in holds:
        print(f'[8 plain holds] {h}', flush=True)
    print(f'[8 phase time] {time.time() - t_phase:.1f} s ({time.time() - t_holds:.1f} s of it the '
          f'plain holds)', flush=True)
    return launches


def recorded_step(trainer, state, batch):
    """The trainer's eager step (train_step's path with a mesh; on one card
    train_step replays a CUDA graph from its second call, which calls no
    optimizer.step to record at), also returning the gradients that the
    optimizer steps with (after a data-parallel trainer's all-reduce), on
    the host, keyed 'ae.<name>' / 'pc.<name>', and the step's symbols (this
    rank's slice) under the key 'symbols'."""
    grads, step = {}, state.optimizer.step
    hook = state.ae.register_forward_hook(
        lambda mod, args, out: grads.__setitem__('symbols', out[0].symbols.detach().cpu()))

    def recording():
        for part, mod in (('ae', state.ae), ('pc', state.pc)):
            grads.update({f'{part}.{n}': p.grad.detach().float().cpu().clone()
                          for n, p in mod.named_parameters() if p.grad is not None})
        step()

    state.optimizer.step = recording
    try:
        state, comps = trainer._eager_step(state, batch)
    finally:
        state.optimizer.step = step
        hook.remove()
    return state, {k: float(v) for k, v in comps.items()}, grads


def dp_rank_steps(rank, world, device, init_method, backend, batches):
    """One rank of phase 9b (in this process at world 1, or spawned): join
    the group, cvpr/low + cvpr/res_shallow from seed 0, cuDNN's
    deterministic algorithms, one step on each global batch in turn (padded
    to a multiple of the world, this rank's slice). Returns per step
    (comps, the {'ae', 'pc'} state dicts on the host, the averaged
    gradients)."""
    import torch
    from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
    from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib

    ae_config, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc_config, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    mesh = mesh_lib.init_process_group(rank, world, device, init_method, backend)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        trainer = trainer_lib.Trainer(ae_config, pc_config, mesh=mesh)
        state = trainer.init_state(0)
        out = []
        for batch in batches:
            shard = mesh_lib.shard_batch(mesh_lib.pad_batch_to_multiple(batch, world), mesh)
            state, comps, grads = recorded_step(trainer, state, shard)
            out.append((comps, {k: {n: t.detach().cpu().clone() for n, t in m.state_dict().items()}
                                for k, m in (('ae', state.ae), ('pc', state.pc))}, grads))
        return out
    finally:
        torch.backends.cudnn.deterministic = prev
        mesh_lib.destroy_process_group()


def dp_training(dev, step_ms6):
    """Phase 9b: the data-parallel train step at full width (cvpr/low +
    cvpr/res_shallow, B=30 160x160, phase 6's batch). World size 1 under
    NCCL: 2 steps against 2 non-parallel steps, cuDNN's deterministic
    algorithms on both sides, equal bit for bit (loss, comps, symbols,
    averaged gradients, parameters). Then 2 ranks sharing the card under gloo against 1 rank, one
    step: the loss to 1e-5 relative, the averaged gradients to twice the
    distance at which one rank's gradients move when the batch is reversed
    (a gradient summed instead of averaged is off by 100%), the parameters
    to the CPU tests' bounds. Returns (launch counts of the
    world-1 run, text)."""
    import torch
    from imgcomp_cvpr_tpu_torch.data import pipeline as pipeline_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
    from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib

    ae_config, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc_config, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    ip = pipeline_lib.InputPipeline(pipeline_lib.get_dataset('synthetic:64'),
                                    ae_config.crop_size, TRAIN_BATCH,
                                    num_preprocess_threads=1, seed=0).start()
    try:
        batch = ip.get_batch()               # phase 6's batch
    finally:
        ip.stop()

    def params(model):
        return {f'{k}.{n}': t.float().cpu() for k, m in model.items() for n, t in m.items()}

    def worst(a, b):
        """Largest |a - b| over a leaf's largest |b|, over the leaves of b."""
        assert set(a) == set(b)
        rel = {n: ((a[n] - b[n]).abs().max() / b[n].abs().max().clamp(min=1e-30)).item()
               for n in b if n != 'symbols'}
        w = max(rel, key=rel.get)
        return rel[w], w

    def norms(a, b):
        """||a - b|| / ||b|| over all gradients, and the range of a leaf's
        ||a|| / ||b||."""
        names = [n for n in b if n != 'symbols']
        diff = sum(((a[n] - b[n]).double() ** 2).sum().item() for n in names) ** 0.5
        ratio = [(a[n].double().norm() / b[n].double().norm()).item() for n in names
                 if b[n].abs().max() > 0]
        return diff / sum((b[n].double() ** 2).sum().item() for n in names) ** 0.5, \
            min(ratio), max(ratio)

    def equal(a, b):
        return set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in b)

    torch.backends.cudnn.deterministic = True
    try:
        trainer = trainer_lib.Trainer(ae_config, pc_config, device=dev)
        state = trainer.init_state(0)
        ref = []
        for _ in range(2):
            state, comps, grads = recorded_step(trainer, state, batch)
            ref.append((comps, params({'ae': state.ae.state_dict(), 'pc': state.pc.state_dict()}),
                        grads))
        torch.cuda.synchronize()
        build.reset_launches()
        world1 = dp_rank_steps(0, 1, str(dev), f'tcp://localhost:{mesh_lib.free_port()}', None,
                               [batch, batch])
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = False
    d_loss = max(abs(a[0]['total_loss'] - b[0]['total_loss']) / abs(b[0]['total_loss'])
                 for a, b in zip(world1, ref))
    d_grad, at_g = max(worst(a[2], b[2]) for a, b in zip(world1, ref))
    d_par, at = worst(params(world1[-1][1]), ref[-1][1])
    exact = all(a[0] == b[0] and equal(a[2], b[2]) and equal(params(a[1]), b[1])
                for a, b in zip(world1, ref))
    if not exact:
        raise AssertionError(f'9b: world-1 data-parallel steps differ from phase 6\'s: loss '
                             f'{d_loss}, gradients {d_grad} at {at_g}, parameters {d_par} at {at}')
    if launches['quantize'] != 2 or launches['quantize_bwd'] != 2:
        raise AssertionError(f'9b: launches {launches}')

    # step time: world 1 (in this process, eager) beside the non-parallel
    # step, eager (the cost of the collectives) and as CUDA-graph replays
    mesh = mesh_lib.init_process_group(0, 1, dev, f'tcp://localhost:{mesh_lib.free_port()}')
    try:
        dp = trainer_lib.Trainer(ae_config, pc_config, device=dev, mesh=mesh)
        xb = torch.from_numpy(batch).to(dev)
        step_ms = {}
        for name, step, s_ in (('dp', dp.train_step, dp.init_state(0)),
                               ('plain', trainer._eager_step, trainer.init_state(0)),
                               ('graph', trainer.train_step, trainer.init_state(0))):
            step(s_, xb)
            step(s_, xb)        # 'graph': the capture
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(5):
                step(s_, xb)
            ev[1].record()
            torch.cuda.synchronize()
            step_ms[name] = ev[0].elapsed_time(ev[1]) / 5
    finally:
        mesh_lib.destroy_process_group()

    # two ranks sharing the card under gloo (deterministic cuDNN in each),
    # against one rank
    t = time.time()
    (comps2, model2, grads2), = mesh_lib.spawn(
        dp_rank_steps, 2, (2, str(dev), f'tcp://localhost:{mesh_lib.free_port()}', 'gloo',
                           [batch]))
    spawn_s = time.time() - t
    torch.backends.cudnn.deterministic = True
    try:
        state, one, grads1 = recorded_step(trainer, trainer.init_state(0), batch)
        # the control: one rank on the batch in reverse order, the same
        # global loss summed in another order
        _, one_r, grads1_r = recorded_step(trainer, trainer.init_state(0), batch[::-1].copy())
    finally:
        torch.backends.cudnn.deterministic = False
    c_loss = abs(one_r['total_loss'] - one['total_loss']) / abs(one['total_loss'])
    c_grad, at_c = worst(grads1_r, grads1)
    c_norm, _, _ = norms(grads1_r, grads1)
    d2_loss = abs(comps2['total_loss'] - one['total_loss']) / abs(one['total_loss'])
    d2_grad, at2_g = worst(grads2, grads1)
    d2_norm, r_lo, r_hi = norms(grads2, grads1)
    half = grads2['symbols']             # rank 0's slice: the first half of the batch
    sym_flips = int((half != grads1['symbols'][:half.shape[0]]).sum().item())
    a, b = params(model2), params({'ae': state.ae.state_dict(), 'pc': state.pc.state_dict()})
    named = {f'ae.{n}' for n, _ in state.ae.named_parameters()} | {
        f'pc.{n}' for n, _ in state.pc.named_parameters()}
    if set(grads1) - {'symbols'} != named:
        raise AssertionError(f'9b: gradients of {len(grads1)} of {len(named)} parameters')
    # The CPU tests' bounds (tests/test_torch_parallel.py) where they carry
    # over to full width: every parameter within rtol 2e-2 / atol 5e-4 and a
    # mean |diff| below 1e-6, here over all parameters together: Adam's
    # first step turns the reduction-order noise of a near-zero gradient
    # entry into a move of up to 2 lr the other way, and one such entry in a
    # 128-entry BatchNorm leaf alone makes that leaf's mean 1.25e-6 (the
    # entries past 1e-5 are counted). The BatchNorm statistics are float32
    # sums over 30 x 160 x 160 values a channel in another order (two
    # halves), whose decoder layers also see any symbol that the encoder's
    # statistics moved: held to phase 6a's tolerance, 1e-3 of the leaf's
    # largest entry (the CPU tests' 1e-6 holds at their tiny widths only).
    # The gradients are held to twice the control's distance: the same
    # global loss summed in another order (the batch reversed, one rank)
    # moves them by ~1.4% over all leaves and ~3% at the worst leaf on an
    # H100 (cancelling sums in the BatchNorm leaves), while a gradient
    # summed instead of averaged is off by 100% on every leaf. The CPU tests
    # hold the gradients to 1e-5 at their widths.
    bad, flips, total, n_el, stat_rel = [], 0, 0.0, 0, 0.0
    for n in a:
        d = (a[n] - b[n]).abs()
        if n in named:
            total, n_el = total + d.sum().item(), n_el + d.numel()
            flips += int((d > 1e-5).sum().item())
            if not torch.all(d <= 5e-4 + 2e-2 * b[n].abs()):
                bad.append((n, d.max().item()))
        else:
            rel = (d.max() / b[n].abs().max().clamp(min=1e-30)).item()
            stat_rel = max(stat_rel, rel)
            if rel > 1e-3:
                bad.append((n, rel))
    if (d2_loss > 1e-5 or d2_grad > 2 * c_grad or d2_norm > 2 * c_norm or bad
            or not total / n_el < 1e-6):
        raise AssertionError(f'9b: 2 gloo ranks vs 1: loss rel {d2_loss}, gradients {d2_grad} '
                             f'at {at2_g} (control {c_grad}), all together {d2_norm} (control '
                             f'{c_norm}), a leaf\'s norm ratio {r_lo}-{r_hi}; {sym_flips} of '
                             f'{half.numel()} symbols of the first half differ; mean |diff| '
                             f'{total / n_el}, off: {bad[:8]}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return launches, (
        f'ae cvpr/low + pc cvpr/res_shallow, B={TRAIN_BATCH} {TRAIN_CROP}x{TRAIN_CROP}, phase '
        f'6\'s batch, seed 0: world size 1 under NCCL, 2 steps vs 2 non-parallel steps '
        f'(deterministic cuDNN): equal bit for bit (loss, comps, symbols, averaged gradients, '
        f'parameters); launches {launches}; {smi}: '
        f'ms a step (CUDA events, 5 steps, default cuDNN) data-parallel world 1 '
        f'{step_ms["dp"]:.3f}, non-parallel eager {step_ms["plain"]:.3f} (phase 6b: '
        f'{step_ms6:.3f}), non-parallel CUDA-graph replays {step_ms["graph"]:.3f}; '
        f'2 ranks sharing the card under gloo (spawned, {spawn_s:.1f} s) vs 1 rank, one step, '
        f'deterministic cuDNN: '
        f'loss rel diff {d2_loss:.3g} (tol 1e-5), {sym_flips} of {half.numel()} symbols of '
        f'the first half differ, averaged gradients {d2_grad:.3g} of a leaf\'s largest entry '
        f'at {at2_g}, {d2_norm:.3g} over all leaves together (a leaf\'s norm ratio '
        f'{r_lo:.5f}-{r_hi:.5f}; tol twice the control\'s: one rank on the batch reversed, '
        f'{c_grad:.3g} at {at_c} and {c_norm:.3g}, loss rel {c_loss:.3g}), every parameter '
        f'within rtol 2e-2 / atol '
        f'5e-4, mean |diff| over all {n_el} parameters {total / n_el:.3g} (tol 1e-6; {flips} '
        f'entries past 1e-5: Adam\'s first step on near-zero gradients), BatchNorm '
        f'statistics within {stat_rel:.3g} of a leaf\'s largest entry (tol 1e-3, phase 6a\'s)')


def dp_validation(dev, val_info):
    """Phase 9c: phase 7's sweep (24 natkodak24 images, eval batch 8 a
    device) with and without real_bpp through EvalModel and LatentCodec
    given the same card twice: the measures rows equal phase 7's one-device
    rows and the streams phase 7's bytes; then phase 7's K=5 run (4 images,
    real_bpp) the same way. Returns (launch counts, text)."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib
    from imgcomp_cvpr_tpu_torch.data import val_images
    from imgcomp_cvpr_tpu_torch.data.images_iterator import ImagesIterator
    from imgcomp_cvpr_tpu_torch.eval import validate as validate_lib
    from imgcomp_cvpr_tpu_torch.eval.val_files import ValidationDirs
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    from imgcomp_cvpr_tpu_torch.training import checkpoint as checkpoint_lib
    from imgcomp_cvpr_tpu_torch.utils import logdir as logdir_lib

    devices = [dev, dev]
    paths, name = val_images.get_image_paths(NATKODAK)
    log = open(os.path.join(VAL_ROOT, 'validate_dp.log'), 'w')
    launches = {}
    out = {}
    for key, log_dir, n_img in (('k3', val_info['log_dir'], VAL_IMAGES),
                                ('k5', val_info['log5'], 4)):
        ckpt_dir = logdir_lib.ckpt_dir_for_log_dir(log_dir)
        em = validate_lib.build_eval_model_from_log_dir(log_dir, device=devices)
        em.set_params(checkpoint_lib.Saver(ckpt_dir).restore(9000)[0]['model'])
        lc = codec_lib.LatentCodec(em.pc, em.pc_config, device=em.devices)
        streams = []

        def recording(syms, centers, encode=lc.encode_batch):
            res = encode(syms, centers)
            streams.extend(r.bitstream for r in res)
            return res

        lc.encode_batch = recording
        for real_bpp in ((False, True) if key == 'k3' else (True,)):
            streams.clear()
            flags = validate_lib.OutputFlags(ckpt_step=-1, real_bpp=real_bpp,
                                             eval_batch=VAL_BATCH)
            torch.cuda.synchronize()
            build.reset_launches()
            t = time.time()
            with contextlib.redirect_stdout(log):
                vd = ValidationDirs(ckpt_dir, os.path.join(VAL_ROOT, 'dp'), name, reset=True)
                validate_lib.validate(vd, ImagesIterator(paths[:n_img], name), flags,
                                      eval_model=em, codec=lc)
            torch.cuda.synchronize()
            out[key, real_bpp] = time.time() - t
            if real_bpp:
                for k, v in build.LAUNCHES.items():
                    launches[k] = launches.get(k, 0) + v
            rows = open(os.path.join(vd.out_dir, 'measures.csv')).read().splitlines()
            want = val_info['rows'] if key == 'k3' else val_info['rows_k5']
            if rows != want:
                raise AssertionError(f'9c: {key} real_bpp={real_bpp}: the rows on two devices '
                                     'differ from phase 7\'s on one')
        if key == 'k3' and streams != val_info['streams'] or len(streams) != n_img:
            raise AssertionError(f'9c: the {key} streams on two devices differ from phase 7\'s')
    log.close()
    for k in ('quantize', 'wavefront_forward_encode', 'wavefront_forward_decode', 'rans_reverse',
              'plane_forward_encode', 'plane_forward_decode', 'plane_reverse'):
        if launches.get(k, 0) < 1:
            raise AssertionError(f'9c: {k} was not launched in the data-parallel real-bpp runs')
    return launches, (
        f'EvalModel and LatentCodec on [{dev}, {dev}] (eval batch {VAL_BATCH} a device, '
        f'buckets of {2 * VAL_BATCH}): phase 7\'s {VAL_IMAGES}-image sweep without and with '
        f'real_bpp gives phase 7\'s measures rows exactly ({out["k3", False]:.2f} s / '
        f'{out["k3", True]:.2f} s wall) and, with real_bpp, its {VAL_IMAGES} streams byte for '
        f'byte; the K=5 run (4 images, real_bpp) its rows ({out["k5", True]:.2f} s); launches '
        f'in the real-bpp runs { {k: v for k, v in launches.items() if v} }')


def parallel_path(dev, val_info, step_ms6):
    """Phase 9: data parallelism. Returns the launch counts of the
    data-parallel runs (9b's train steps, 9c's validation), each read just
    after its run."""
    t_phase = time.time()
    train_launches, text = dp_training(dev, step_ms6)
    print(f'[9b data-parallel training] {text}', flush=True)
    val_launches, text = dp_validation(dev, val_info)
    print(f'[9c data-parallel validation] {text}', flush=True)
    print(f'[9 phase time] {time.time() - t_phase:.1f} s', flush=True)
    return {'train': train_launches, 'val': val_launches}


def main_path(ae, codec, x, centers):
    """One pass of a codec's main path through its entry points, with the
    launch counts set to 0 just before it and read just after: AE encode ->
    entropy encode -> container -> parse -> entropy decode (CRC verified) ->
    AE decode. Raises unless the round trip is bit-exact and the
    reconstruction finite. Returns (launches, facts for roundtrip_line)."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    B, H, W, _ = x.shape
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
    launches = dict(build.LAUNCHES)
    if not torch.equal(decoded.long(), syms.long()):
        raise AssertionError('main path: decoded symbols differ')
    if tuple(x_rec.shape) != (B, H, W, 3) or not torch.isfinite(x_rec).all():
        raise AssertionError(f'main path: bad reconstruction {tuple(x_rec.shape)}')
    impl = {codec_lib.stream_impl_id(r.bitstream) for r in results}
    if impl != {codec.impl_id}:
        raise AssertionError(f'main path: impl ids {impl}')
    precs = {codec_lib.stream_prec(r.bitstream) for r in results}
    mse = torch.mean((x_rec - x) ** 2).item()
    bits = sum(r.num_bits for r in results)
    theo = sum(r.theoretical_bits for r in results)
    # Tail packing (x0 = 1): a lane's last k symbols in decode order cost
    # no stream words; runs of symbol 0 (start 0) there are free, so a
    # model that predicts them badly can code below its own theory.
    ks = [codec_lib.deserialize_stream(r.bitstream)[4] for r in results]
    return launches, dict(
        syms=syms, precs=precs, bpp=bits / (B * H * W), overhead=100 * (bits / theo - 1),
        theo_bpp=theo / (B * H * W),
        warm=np.mean([0 if k is None else int(k.sum()) for k in ks]),
        psnr=10 * np.log10(255.0 ** 2 / mse),
        legs=[ev[i].elapsed_time(ev[i + 1]) for i in range(4)], wall=wall,
        mp=B * H * W / 1e6)


def roundtrip_line(rt):
    legs = rt['legs']
    return (f'CRC-verified bit-exact round-trip; bpp {rt["bpp"]:.5f}, real/theory overhead '
            f'{rt["overhead"]:.4f}% (tail-packed warmup {rt["warm"]:.1f} symbols/image), PSNR '
            f'{rt["psnr"]:.3f} dB; ms: ae_encode {legs[0]:.3f}, entropy_encode {legs[1]:.3f}, '
            f'entropy_decode {legs[2]:.3f}, ae_decode {legs[3]:.3f}; wall '
            f'{rt["wall"] * 1e3:.1f} ms = {rt["mp"] / rt["wall"]:.4f} MP/s enc+dec')


def same_bits(a, b):
    """True where a and b have the same dtype, shape and bits, NaN payloads
    aside (a NaN must stay a NaN)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.contiguous(), b.contiguous()
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(bits)[~nan], b.view(bits)[~nan])


def ae_epilogue_path(dev, ae_config, ae, lc, x, centers, rows):
    """Phase 4d: the AE's fused eval-mode conv epilogue on phase 4's main
    path. The trained towers in bf16 at B=16 and B=1 and in f32 at B=16
    each run main_path (K=3) with ``ae_epilogue.epilogue`` wrapped: every
    call's kernel output is held against epilogue_plain on the same operands
    (the conv output as the conv left it, the folded BatchNorm operands, the
    residuals) bit for bit; the pass's launches, read from its own reset
    counters, must be 35 + 35. Then one encode and decode of the same images
    times each distinct call (dtype, shape, residuals, crop view, ReLU) the
    first time it comes: kernel and plain chain each as a CUDA graph of 20
    calls (graph_ms), beside its bound (y, the residuals and the output read
    or written once, at 3.35 TB/s). Raises on any mismatch. Fills
    rows['ae_epilogue'] (sums over the bf16 B=16 pass's 70 calls) and
    returns that pass's launches."""
    import torch
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import ae_epilogue as epi
    t_phase = time.time()
    ae16 = ae_lib.CVPRAutoencoder(ae_config, device=dev, dtype=torch.bfloat16)
    ae16.load_state_dict(ae.state_dict())          # the trained float32 parameters
    real = epi.epilogue
    cl = torch.channels_last

    def call_key(y, act, residuals):
        return (str(y.dtype).split('.')[-1], tuple(y.shape), len(residuals),
                not y.is_contiguous(memory_format=cl), bool(act))

    passes, launches = {}, {}
    try:
        for label, model, xb in (('bf16_b16', ae16, x), ('bf16_b1', ae16, x[:1]),
                                 ('f32_b16', ae, x)):
            keys = []

            def checked(y, mean, mul, bias, act, residuals=()):
                out = real(y, mean, mul, bias, act, residuals)
                keys.append(call_key(y, act, residuals))
                if not same_bits(out, epi.epilogue_plain(y, mean, mul, bias, act, residuals)):
                    raise AssertionError(f'4d ae_epilogue {label}: call {len(keys)} '
                                         f'{keys[-1]} differs from epilogue_plain')
                return out

            epi.epilogue = checked
            launches[label], _ = main_path(model, lc, xb, centers)
            n_launch = launches[label]['ae_epilogue']
            if n_launch != 70 or len(keys) != 70:
                raise AssertionError(f'4d ae_epilogue {label}: {n_launch} launches, {len(keys)} '
                                     f'calls a round trip, not 35 + 35')
            times = {}

            def timed(y, mean, mul, bias, act, residuals=()):
                key = call_key(y, act, residuals)
                if key not in times:
                    args = (y, mean, mul, bias, act, residuals)
                    nbytes = y.element_size() * y.numel() * (2 + len(residuals)) + 12 * y.shape[1]
                    times[key] = (graph_ms(lambda: real(*args), 20),
                                  graph_ms(lambda: epi.epilogue_plain(*args), 20),
                                  bound(nbytes, 0)[0])
                return real(y, mean, mul, bias, act, residuals)

            epi.epilogue = timed
            with torch.no_grad():
                model.decode(model.encode(xb).qhard)
            torch.cuda.synchronize()
            calls = [dict(dtype=k[0], shape=list(k[1]), residuals=k[2], crop=k[3], act=k[4],
                          calls=keys.count(k), ms=t[0], plain_ms=t[1], bound_ms=t[2])
                     for k, t in times.items()]
            if sum(c['calls'] for c in calls) != 70:
                raise AssertionError(f'4d ae_epilogue {label}: the timed pass made other calls')
            passes[label] = dict(
                launches=n_launch, calls=calls,
                ms=sum(c['calls'] * c['ms'] for c in calls),
                plain_ms=sum(c['calls'] * c['plain_ms'] for c in calls),
                bound_ms=sum(c['calls'] * c['bound_ms'] for c in calls))
    finally:
        epi.epilogue = real
    for label, p in passes.items():
        print(f'[4d ae_epilogue {label}] {p["launches"]} launches a round trip, every call bit '
              f'for bit its plain chain; a round trip\'s epilogues {p["ms"]:.3f} ms (plain '
              f'chain {p["plain_ms"]:.3f} ms, bound {p["bound_ms"]:.3f} ms); by call (dtype, '
              f'shape, residuals, crop, ReLU: calls, us kernel / plain / bound): '
              + '; '.join(f'{c["dtype"]} {c["shape"]} r{c["residuals"]}'
                          f'{" crop" if c["crop"] else ""}{" relu" if c["act"] else ""}: '
                          f'{c["calls"]}, {c["ms"] * 1e3:.1f} / {c["plain_ms"] * 1e3:.1f} / '
                          f'{c["bound_ms"] * 1e3:.1f}' for c in p['calls']), flush=True)
    main = passes['bf16_b16']
    rows['ae_epilogue'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/ae_epilogue.cu', replaces=None,
        max_abs_err=0.0, ms=main['ms'], plain_ms=main['plain_ms'],
        bound=(main['bound_ms'], 'bytes'), library_ms=None, passes=passes)
    print(f'[4d phase time] {time.time() - t_phase:.1f} s', flush=True)
    return launches['bf16_b16']


def k3_streams(fsel, ssel, shape):
    """Kernel 3 (x0 = 1) on (B, T, CQ) tables -> (kernel 2's decode inputs:
    dict(streams (B, cap) in decode order, init_states, thresh), the words
    of all streams)."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
    dev, B = fsel.device, fsel.shape[0]
    sched = ck.build_schedule(shape)
    w, n_w, st, k = ck.rans_reverse(fsel, ssel, shape, 1)
    streams = torch.zeros(B, sched.stream_cap, dtype=torch.int32, device=dev)
    for i in range(B):
        streams[i, :n_w[i]] = w[i, :n_w[i]].flip(0)
    thresh = (torch.from_numpy(ck.lane_totals(sched)).to(dev)[None] - k).int().contiguous()
    return dict(streams=streams, init_states=st, thresh=thresh), int(n_w.sum().item())


def k3_kernel_times(fw, shape, syms_flat, force=0, prec=0):
    """Kernel 2 at these weights, symbols and operand precision: (encode
    tables, scan tables, layer-parallel encode ms (5 launches), scan decode
    ms (on the cluster the wrapper picks), decoded symbols). The decode reads
    streams that kernel 3 wrote from the encode tables."""
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
    kw = dict(force=force, prec=prec)
    f_k, s_k = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=syms_flat, **kw)
    f_s, s_s = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=syms_flat, scan=True,
                                    **kw)
    enc_ms = cuda_ms(lambda: ck.wavefront_forward(ck.MODE_ENCODE, fw, shape,
                                                  true_syms=syms_flat, **kw), 2)
    args = dict(k3_streams(f_k, s_k, shape)[0], **kw)
    dec = ck.wavefront_forward(ck.MODE_DECODE, fw, shape, **args)
    dec_ms = cuda_ms(lambda: ck.wavefront_forward(ck.MODE_DECODE, fw, shape, **args))
    return (f_k, s_k), (f_s, s_s), enc_ms, dec_ms, dec


def wide_context_models(dev, ae, ae_config, x, centers, fw24):
    """Phase 4b: context models whose weights pass a block's shared memory,
    so that kernels 2 and 5 read them from device memory (seeded weights:
    no trained kf = 64 model exists in the repository).
      - K=3, `pc cvpr/res_shallow_64` (kf = 64) with the trained `cvpr/low`
        AE, B=16 512x768: the main path through the entry points (launch
        counts from 0), then kernel 2's tables at kf = 64 against its scan
        (every entry) and its plain version, the compile-time kf = 64
        instance against the generic one (tables equal, times), and at kf =
        24 the scan with its weights in device memory against shared memory;
      - K=3 at `ae cvpr/hi` (C = 64, seeded) + `pc cvpr/res_shallow_64`,
        B=4 (the depth of the batch cut for time only): the main path, and
        the tables against the scan;
      - K=5 at kf = 64 (`pc base` with arch_param__k = 64, seeded) with the
        trained AE, B=16: the main path, kernel 5's layer-parallel tables
        against its plane-by-plane scan on every plane, its times.
    Returns the launch counts of the first main path."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib, cuda_codec
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck, planar_codec
    from imgcomp_cvpr_tpu_torch.coding import planar_kernel as plk
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
    from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib
    pc64_config, _ = config_lib.parse_spec('cvpr/res_shallow_64', 'pc')
    kf = pc64_config.arch_param__k
    pc64 = pc_lib.init_params(pc_lib.ProbClassifier(pc64_config, ae_config.num_centers,
                                                    device=dev), seed=0)
    lc64 = codec_lib.LatentCodec(pc64, pc64_config, device=dev)
    launches, rt = main_path(ae, lc64, x, centers)
    if not rt['psnr'] > 15.0:
        raise AssertionError(f'4b: reconstruction PSNR {rt["psnr"]:.2f} dB')
    for name in ('quantize', 'wavefront_forward_encode', 'wavefront_forward_decode',
                 'rans_reverse'):
        if launches[name] < 1:
            raise AssertionError(f'4b: kernel {name} was not launched on the kf = 64 path')
    syms = rt['syms']
    B, C, H, W = syms.shape
    shape, n = (C, H, W), C * H * W
    sched = ck.build_schedule(shape)
    L = ae_config.num_centers
    place = {e: 'device memory' if ck.weights_in_device(kf, L, sched.CQ, sched.T, encode=e)
             else 'shared memory' for e in (False, True)}
    cluster = ck.scan_cluster(kf, L, sched.CQ, sched.T, B)
    fw = cuda_codec.fold_weights(pc64, centers)
    syms_flat = syms.reshape(B, n).int().contiguous()
    (f_k, s_k), (f_s, s_s), enc_ms, dec_ms, dec = k3_kernel_times(fw, shape, syms_flat)
    if not (torch.equal(f_k, f_s) and torch.equal(s_k, s_s)):
        raise AssertionError('4b: kf = 64 encode tables differ from the scan\'s')
    if not torch.equal(dec, syms_flat):
        raise AssertionError('4b: kf = 64 decode did not recover the symbols')
    plain_ms, (f_p, s_p) = host_ms(lambda: ck.wavefront_encode_plain(fw, shape, syms_flat))
    act = torch.from_numpy(sched.idx_cm < n).to(dev)
    entries = int(act.sum().item()) * B
    flips = int((((f_k != f_p) | (s_k != s_p)) & act).sum().item())
    if flips > 1e-3 * entries:
        raise AssertionError(f'4b: kf = 64 encode: {flips} flips vs plain of {entries}')
    (f_g, s_g), _, enc_g_ms, dec_g_ms, dec_g = k3_kernel_times(fw, shape, syms_flat,
                                                                ck.FORCE_GENERIC)
    if not (torch.equal(f_g, f_k) and torch.equal(s_g, s_k) and torch.equal(dec_g, dec)):
        raise AssertionError('4b: the generic instance differs from the kf = 64 one')
    t24 = {force: k3_kernel_times(fw24, shape, syms_flat, force)
           for force in (0, ck.FORCE_WDEV)}
    if not all(torch.equal(a, b) for a, b in zip(t24[0][0] + (t24[0][4],),
                                                 t24[ck.FORCE_WDEV][0] + (t24[ck.FORCE_WDEV][4],))):
        raise AssertionError('4b: kf = 24 with the weights in device memory differs')
    print(f'[4b wide context model] K=3 trained AE + seeded pc cvpr/res_shallow_64 (kf={kf}, '
          f'L={L}), B={B} {IMG_H}x{IMG_W} latent {shape}: ' + roundtrip_line(rt) + '; '
          f'launches {launches}; kernel 2 weights in {place[False]} (scan) and '
          f'{place[True]} (encode), scan on clusters of {cluster}; layer-parallel encode '
          f'{enc_ms:.3f} ms, tables equal to the scan\'s on all {f_k.numel()} entries and to '
          f'the plain version\'s but {flips} of {entries} ({plain_ms:.0f} ms); scan decode '
          f'{dec_ms:.3f} ms; the generic instance: encode {enc_g_ms:.3f} ms, decode '
          f'{dec_g_ms:.3f} ms (same tables and symbols); kf=24 trained model, weights in '
          f'shared vs device memory: encode {t24[0][2]:.3f} vs '
          f'{t24[ck.FORCE_WDEV][2]:.3f} ms, decode {t24[0][3]:.3f} vs '
          f'{t24[ck.FORCE_WDEV][3]:.3f} ms (same tables and symbols)', flush=True)

    # ae cvpr/hi: C = 64, a latent depth the other phases do not run.
    hi_config, _ = config_lib.parse_spec('cvpr/hi', 'ae')
    ae_hi = ae_lib.init_params(ae_lib.CVPRAutoencoder(hi_config, device=dev), seed=0)
    c_hi = ae_hi.encoder.centers.detach()
    b_hi = 4
    _, cold = main_path(ae_hi, lc64, x[:b_hi], c_hi)      # the first call at this shape
    launches_hi, rt_hi = main_path(ae_hi, lc64, x[:b_hi], c_hi)
    syms_hi = rt_hi['syms']
    shape_hi = tuple(syms_hi.shape[1:])
    fw_hi = cuda_codec.fold_weights(pc64, c_hi)
    flat_hi = syms_hi.reshape(b_hi, -1).int().contiguous()
    (f_k, s_k), (f_s, s_s), enc_hi_ms, dec_hi_ms, dec_hi = k3_kernel_times(fw_hi, shape_hi,
                                                                            flat_hi)
    if not (torch.equal(f_k, f_s) and torch.equal(s_k, s_s) and torch.equal(dec_hi, flat_hi)):
        raise AssertionError('4b: ae cvpr/hi: tables differ from the scan\'s or decode fails')
    print(f'[4b wide latent] seeded ae cvpr/hi (C={hi_config.num_chan_bn}) + seeded pc '
          f'cvpr/res_shallow_64, B={b_hi} {IMG_H}x{IMG_W} latent {shape_hi}: '
          + roundtrip_line(rt_hi) + f' (the first call at this shape, building its '
          f'schedule: legs {[round(t, 3) for t in cold["legs"]]} ms); launches {launches_hi}; '
          f'kernel 2 encode {enc_hi_ms:.3f} ms (tables equal to the scan\'s on all '
          f'{f_k.numel()} entries), scan decode {dec_hi_ms:.3f} ms', flush=True)

    # K = 5 at kf = 64.
    pc5_config, _ = config_lib.parse_spec('base', 'pc')
    pc5_config = pc5_config.replace(arch_param__k=kf)
    pc5 = pc_lib.init_params(pc_lib.ProbClassifier(pc5_config, L, device=dev), seed=0)
    lc5 = codec_lib.LatentCodec(pc5, pc5_config, device=dev)
    launches5, rt5 = main_path(ae, lc5, x, centers)
    for name in ('plane_forward_encode', 'plane_forward_decode', 'plane_reverse'):
        if launches5[name] < 1:
            raise AssertionError(f'4b: kernel {name} was not launched on the K=5 kf = 64 path')
    coder = planar_codec.PlanarCoder(pc5, pc5_config, device=dev)
    psched, fold = coder._prepare(shape, centers)
    place5 = {s_: 'device memory' if plk.weights_in_device(fold.top, shape, coder.K, scan=s_)
              else 'shared memory' for s_ in (True, False)}
    syms5 = rt5['syms'].int().contiguous()
    par5_ms, enc5_ms, (fk5, sk5), _ = planar_encode_launch_ms(coder, syms5, fold)
    scan_ms, (fs5, ss5) = host_ms(lambda: coder.encode_tables_scan(syms5, fold))
    bias = coder.bias_rows(fold, coder._history(fold, psched, B))
    plane_ms = cuda_ms(lambda: plk.plane_forward(plk.MODE_ENCODE, fold.top, shape, coder.K,
                                                 bias, true_plane=syms5[:, 0].contiguous()), 2)
    if not (torch.equal(fk5, fs5) and torch.equal(sk5, ss5)):
        raise AssertionError('4b: K=5 kf = 64 tables differ from the scan\'s')
    print(f'[4b wide K=5] trained AE + seeded pc base with arch_param__k={kf}, B={B} latent '
          f'{shape}: ' + roundtrip_line(rt5) + f'; launches {launches5}; kernel 5 weights in '
          f'{place5[True]} (scan) and {place5[False]} (level passes); encode_tables '
          f'{enc5_ms:.3f} ms, of which kernel 5\'s 5 launches (levels 1-4, tables) '
          f'{[round(t, 3) for t in par5_ms]} = {sum(par5_ms):.3f} ms; tables equal to the '
          f'plane-by-plane scan\'s on all {fk5.numel()} entries; kernel 5\'s scan '
          f'{plane_ms:.3f} ms a plane ({scan_ms:.1f} ms over {C} planes in mode 1 with the '
          f'bias-row launches)', flush=True)
    return launches


def straight_streams(pc, pc_config, syms, centers):
    """An encode as one straight pass through the kernel wrappers, with no
    handle in between (the flow of encode_batch before the submit / finish
    split): tables, reverse encode, serialize. The reference of phase 4c's
    stream equality."""
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib, cuda_codec
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck, planar_codec, rans
    from imgcomp_cvpr_tpu_torch.coding import planar_kernel as plk
    b, shape = syms.shape[0], tuple(syms.shape[1:])
    syms = syms.int().contiguous()
    if pc_config.kernel_size == 3:
        fsel, ssel = ck.wavefront_forward(ck.MODE_ENCODE, cuda_codec.fold_weights(pc, centers),
                                          shape, true_syms=syms.reshape(b, -1))
        totals, impl = ck.lane_totals(ck.build_schedule(shape)), codec_lib.IMPL_CUDA
    else:
        coder = planar_codec.PlanarCoder(pc, pc_config, device=syms.device)
        fsel, ssel = coder.encode_tables(syms, planar_codec.fold_planar(pc, centers))
        totals, impl = coder.lane_totals(shape), codec_lib.IMPL_CUDA_PLANAR
    tail = totals.max() >= codec_lib.TAIL_MIN_LANE_SYMBOLS
    x0 = 1 if tail else rans.RANS_L
    out = (ck.rans_reverse(fsel, ssel, shape, x0) if pc_config.kernel_size == 3
           else plk.plane_reverse(fsel, ssel, shape, pc_config.kernel_size, x0))
    words, n_words, states, k = (t.cpu().numpy() for t in out)
    host = syms.cpu().numpy()
    return [codec_lib.serialize_stream(
        shape, words[i, :n_words[i]][::-1].astype(np.uint32), states[i].view(np.uint32),
        codec_lib.symbol_crc(host[i]), impl_id=impl, k=k[i] if tail else None)
        for i in range(b)]


def serving_path(dev, ae_config, ae, lc, lc5, pc, pc_config, pc5, pc5_config, x, centers,
                 one_pass_mps):
    """Phase 4c: the serving path that bench_torch.py times, on the card.
      - bench_torch.run_pipeline (depth-2 pipeline over the codec's submit /
        finish, decode with device_out) at B=16 Kodak size with the trained
        K=3 model, f32 towers then bf16 towers, 2 loops x 2 batches each,
        with the launch counts from 0 over each dtype's loops;
      - submit / finish streams byte-equal to a straight pass through the
        kernel wrappers at B=16 (K=3) and B=3 (K=5), also with two handles
        outstanding finished in order;
      - the submits (symbols on the card and numpy, host centers) under
        torch.cuda.set_sync_debug_mode('error'): none waits for the card;
        the AE encode under 'warn', its synchronizing calls counted;
      - the bf16 round trip CRC-verified bit-exact, its symbols' agreement
        with the f32 towers' (raises below the CPU test's 99% bound), the
        PSNR of each reconstruction against the input, the bf16 AE legs;
      - one-image roundtrip and decode(device_out=False) of image 0.
    Returns the launch counts of the bf16 pipelined loops."""
    import warnings
    import torch
    import bench_torch
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    t_phase = time.time()
    B, H, W, _ = x.shape
    mp = B * H * W / 1e6
    host_c = centers.cpu().numpy()
    ae16 = ae_lib.CVPRAutoencoder(ae_config, device=dev, dtype=torch.bfloat16)
    ae16.load_state_dict(ae.state_dict())          # the trained float32 parameters
    loops, launches = {}, {}
    for name, model in (('f32', ae), ('bf16', ae16)):
        torch.cuda.synchronize()
        build.reset_launches()
        loops[name] = [mp / bench_torch.run_pipeline(lc, model, x, host_c, 2, dev).seconds
                       for _ in range(2)]
        launches[name] = dict(build.LAUNCHES)
        for k in ('quantize', 'wavefront_forward_encode', 'wavefront_forward_decode',
                  'rans_reverse'):
            if launches[name][k] < 1:
                raise AssertionError(f'4c: kernel {k} was not launched on the {name} pipeline')
    shape = tuple(bench_torch.ae_encode_syms(ae, x[:1]).shape[1:])
    cols = lc.coder(lc.impl_id)._cols[shape]
    cap = ck.build_schedule(shape).stream_cap
    print(f'[4c pipelined] bench_torch.run_pipeline, K=3 trained, B={B} {H}x{W}, 2 loops x 2 '
          f'batches: f32 towers {[round(v, 4) for v in loops["f32"]]} MP/s, bf16 towers '
          f'{[round(v, 4) for v in loops["bf16"]]} MP/s (phase 4 one pass, f32: '
          f'{one_pass_mps:.4f} MP/s); launches f32 {launches["f32"]}, bf16 '
          f'{launches["bf16"]}; stream words copied at submit (predicted from the batch '
          f'before): {cols} an image = {4 * cols * B} bytes at B={B}, {4 * cols * 64} at B=64 '
          f'(the whole buffer: {4 * cap * B} / {4 * cap * 64} bytes)', flush=True)

    syms = bench_torch.ae_encode_syms(ae, x)
    syms5 = syms[:3].contiguous()
    for name, codec, model, s in (('K=3', lc, pc, syms), ('K=5', lc5, pc5, syms5)):
        cfg = pc_config if codec is lc else pc5_config
        ref = straight_streams(model, cfg, s, centers)
        if [r.bitstream for r in codec.encode_batch(s, host_c)] != ref:
            raise AssertionError(f'4c {name}: encode_batch streams differ from the straight pass')
        half = s.shape[0] // 2
        h1 = codec.encode_batch_submit(s[:half], host_c)
        h2 = codec.encode_batch_submit(s[half:].cpu().numpy(), host_c)
        if [r.bitstream for r in codec.encode_batch_finish(h1)
                + codec.encode_batch_finish(h2)] != ref:
            raise AssertionError(f'4c {name}: two outstanding handles differ')
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            t0 = time.time()
            he = codec.encode_batch_submit(s, host_c)
            t_enc = time.time() - t0
            t0 = time.time()
            hd = codec.decode_batch_submit(ref, host_c)
            t_dec = time.time() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t0 = time.time()
        ok = [r.bitstream for r in codec.encode_batch_finish(he)] == ref
        t_fin = time.time() - t0
        dec = codec.decode_batch_finish(hd)
        if not ok or not torch.equal(dec, s):
            raise AssertionError(f'4c {name}: submits under sync-debug mode differ')
        print(f'[4c streams] {name}, B={s.shape[0]}: encode_batch and submit / finish (also two '
              f'handles outstanding, device and numpy symbols) byte-equal to the straight pass; '
              f'encode and decode submits raise no synchronizing call under '
              f'set_sync_debug_mode("error") (host ms: encode submit {t_enc * 1e3:.1f}, decode '
              f'submit {t_dec * 1e3:.1f}, encode finish {t_fin * 1e3:.1f})', flush=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            bench_torch.ae_encode_syms(ae16, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ae_syncs = sum('synchroniz' in str(w.message) for w in caught)

    launches16, rt16 = main_path(ae16, lc, x, centers)
    syms16 = rt16['syms']
    agree = (syms16 == syms).double().mean().item()
    with torch.no_grad():
        rec32 = ae.decode(centers[syms.long()].permute(0, 2, 3, 1))
    psnr32 = 10 * np.log10(255.0 ** 2 / torch.mean((rec32 - x) ** 2).item())
    if agree < 0.99:
        raise AssertionError(f'4c: bf16 symbols agree with f32 on {agree:.5f} < 0.99')
    print(f'[4c bf16] trained AE with bf16 towers, K=3, B={B}: ' + roundtrip_line(rt16)
          + f'; symbols equal to the f32 towers\' on {agree * 100:.3f}% (bound 99%); PSNR '
          f'against the input: bf16 {rt16["psnr"]:.3f} dB, f32 {psnr32:.3f} dB; '
          f'synchronizing calls in a bf16 AE encode: {ae_syncs}', flush=True)

    img0 = syms[0].cpu().numpy()
    rt = lc.roundtrip(img0, host_c)
    one = lc.decode(rt.bitstream, host_c)
    if one.dtype != np.int32 or not np.array_equal(one, img0):
        raise AssertionError('4c: decode(device_out=False) of image 0 differs')
    print(f'[4c one image] roundtrip of image 0 bit-exact ({rt.num_bits} bits, '
          f'{rt.num_bits / (H * W):.5f} bpp); decode returns np.int32 {one.shape}; phase '
          f'{time.time() - t_phase:.1f} s', flush=True)
    return launches['bf16']


def bound(nbytes, flops, flops_per_s=H100_F32_FLOPS):
    t_b, t_f = nbytes / H100_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_b, 'bytes') if t_b >= t_f else (t_f, 'operations')


def k3_flops(sched, fw, B):
    """Operations of kernel 2's four layer sums over the unmasked taps of
    every cell of their grids, for B images."""
    macs = 0
    for li, layer in enumerate(sched.layers):
        cin = 1 if li == 0 else fw.w2.shape[1]
        cout = fw.w4.shape[-1] if li == 3 else fw.w2.shape[-1]
        macs += layer.taps.shape[0] * layer.taps.shape[1] * cin * cout
    return 2 * macs * B


# The streams of ab_streams' default workload (latent (16, 24, 36), batch 8,
# seeded random-init context model and symbols), sha256 of the batch
# (ab_streams.digest), as the parent commit of a change to kernel 2 wrote
# them on an H100, by (impl, precision): kernels 2 and 3 (cuda, K=3) at
# prec 0, 1 and 2 ($IMGCOMP_PALLAS_PREC), and 5 and 6 (cuda_planar, K=5) at
# prec 0. The prec-0 digests date from before the bf16 / f8 instances, the
# prec-1 and prec-2 ones from before their operands were stored at their own
# precision; neither change was to move a byte. The cuda_planar digest dates
# from the bias-row kernel (csrc/bias_rows.cu), whose fixed float32 sum order
# replaced cuDNN's and moved the id-6 bytes (before it:
# 2e1de80d34049fb433d94689d77d6de79351492fcc598e72dad30ab45726c530).
AB_DIGESTS = {
    ('cuda', 'f32'): 'd2a2e7e149d8cf0748cabe87c500d333ec18494cf7e8c024e97d17fc9b0a3078',
    ('cuda', 'bf16'): '49fad3265bc642c8daee63ed65d9117f23af32d4eddd8a0474ecaa9630e55051',
    ('cuda', 'f8'): '6f4be8a2c6a72407c578d2e19be4d3c2d9ee5ee3f7f9bab950b6bc5705f0eb2e',
    ('cuda_planar', 'f32'): 'c222ce792a533f591d6649116e4590f0942909f930b0aadc94e68b6f07be91ca'}


def operand_bytes(sched, B, kf, L, prec, decode, n_words=0):
    """Bytes of kernel 2's operands at precision 1 or 2, at their storage
    types (cuda_kernel's ACT_DTYPE / Q_DTYPE), each written once and read
    once: q, the three hidden layers' activations and layer 1's float32
    copy, then for the encode the logits, the symbols and the tables, for
    the decode the stream words and the symbols. A computed floor on the
    memory traffic of a design that passes every layer through device
    memory, which both entries do (bound_ms counts inputs and outputs
    only); phase 10 prints it, the kernels line does not carry it."""
    n = int(np.prod(sched.latent_shape))
    acts = sum(B * (c.G + 1) * kf for c in sched.layers[:3])
    total = (B * (n + 1) * 2 + 2 * acts * (2, 1)[prec - 1]
             + 2 * B * (sched.layers[0].G + 1) * kf * 4)
    if decode:
        return total + 4 * n_words + 4 * B * n
    return total + 2 * 4 * B * n * L + 4 * B * n + 2 * 4 * B * sched.T * sched.CQ


def precision_path(dev, ae, pc, pc_config, x, centers, rt4, rows):
    """Phase 10: kernel 2 at its operand precisions bf16 and f8 (container
    prec 1 and 2; the TPU kernel's make_forward(prec='bf16' | 'f8')) with the
    trained K=3 model on phase 4's images and symbols (B=16, latent (32, 64,
    96)). Each precision: the main path through LatentCodec(prec=...) with
    the launch counts set to 0 just before and read just after (its
    kernel-2 instance must launch, the f32 one must not), CRC-verified
    bit-exact, the streams' prec byte checked, leg ms (and those of a second
    pass, without the precision's first use), bpp and real/theory
    overhead beside phase 4's f32; kernel 2's layer-parallel tables equal to
    its scan's mode-1 tables and to its plain version's on every entry, its
    times (3a, 3b) and the plain decode of the same streams. Then a seeded
    kf = 64 context model (weights in device memory) and a seeded kf = 8
    one (the generic instance) at B=2 through the same checks; last, the
    prec-0 streams of ab_streams' workload (K=3 and K=5) against the parent
    commit's digests. Fills the kernels line's rows of the two precisions;
    returns the main paths' launch counts by precision."""
    import io
    import pickle
    import torch
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib, cuda_codec
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
    from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
    from imgcomp_cvpr_tpu_torch.tools import ab_streams
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib
    t_phase = time.time()
    syms = rt4['syms']
    B, C, H, W = syms.shape
    shape, n = (C, H, W), C * H * W
    sched = ck.build_schedule(shape)
    fw = cuda_codec.fold_weights(pc, centers)
    syms_flat = syms.reshape(B, n).int().contiguous()
    flops = k3_flops(sched, fw, B)
    table_bytes = 2 * 4 * B * sched.T * sched.CQ
    launches = {}
    for prec in ck.PRECS[1:]:
        p = ck.prec_id(prec)
        enc_name = ck.launch_name('wavefront_forward_encode', p)
        dec_name = ck.launch_name('wavefront_forward_decode', p)
        lc = codec_lib.LatentCodec(pc, pc_config, device=dev, prec=prec)
        launches[prec], rt = main_path(ae, lc, x, centers)
        ran = launches[prec]
        if min(ran[enc_name], ran[dec_name], ran['rans_reverse'], ran['quantize']) < 1:
            raise AssertionError(f'10 {prec}: a kernel of the path was not launched: {ran}')
        if ran['wavefront_forward_encode'] or ran['wavefront_forward_decode']:
            raise AssertionError(f'10 {prec}: the precision-0 instance ran on the path')
        if rt['precs'] != {p}:
            raise AssertionError(f'10 {prec}: streams carry prec bytes {rt["precs"]}')
        # The same pass again: what of the first was the precision's first use.
        warm = main_path(ae, lc, x, centers)[1]['legs']
        # f32 on the same symbols: the rate that the precision costs.
        ref = codec_lib.LatentCodec(pc, pc_config, device=dev, prec='f32').encode_batch(
            rt['syms'], centers)
        pix = B * IMG_H * IMG_W
        bpp0 = sum(r.num_bits for r in ref) / pix
        theo0 = sum(r.theoretical_bits for r in ref) / pix
        (f_k, s_k), (f_s, s_s), enc_ms, dec_ms, dec = k3_kernel_times(fw, shape, syms_flat,
                                                                      prec=p)
        plain_ms, (f_p, s_p) = host_ms(lambda: ck.wavefront_encode_plain(fw, shape, syms_flat,
                                                                         prec=p))
        if not (torch.equal(f_k, f_s) and torch.equal(s_k, s_s)):
            raise AssertionError(f'10 {prec}: layer-parallel tables differ from the scan\'s')
        if not (torch.equal(f_k, f_p) and torch.equal(s_k, s_p)):
            raise AssertionError(f'10 {prec}: tables differ from the plain version\'s')
        if not torch.equal(dec, syms_flat):
            raise AssertionError(f'10 {prec}: the scan did not recover the symbols')
        args, n_words = k3_streams(f_k, s_k, shape)
        for c in (8, 4, 2, 1):          # the scan on clusters of any size
            if not torch.equal(ck.wavefront_forward(ck.MODE_DECODE, fw, shape, prec=p,
                                                    cluster=c, **args), syms_flat):
                raise AssertionError(f'10 {prec}: the scan on clusters of {c} did not '
                                     'recover the symbols')
        dec_plain_ms, dec_p = host_ms(lambda: ck.wavefront_forward_plain(
            ck.MODE_DECODE, fw, shape, prec=p, **args))
        if not torch.equal(dec_p, syms_flat):
            raise AssertionError(f'10 {prec}: the plain decode did not recover the symbols')
        lib_ms = library_logits_ms(pc, centers, syms, torch.bfloat16) if p == 1 else None
        common = dict(route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/wavefront_forward.cu',
                      replaces='imgcomp_cvpr_tpu/coding/pallas_kernel.py:1089')
        act = torch.from_numpy(sched.idx_cm < n).to(dev)
        enc_err = float(((f_k - f_p).abs() * act).max().item())
        kf, L = fw.w2.shape[-1], fw.w4.shape[-1]
        rows[enc_name] = dict(common, max_abs_err=enc_err, ms=enc_ms, plain_ms=plain_ms,
                              bound=bound(4 * B * n + table_bytes, flops, H100_BF16_FLOPS),
                              library_ms=lib_ms)
        rows[dec_name] = dict(common, max_abs_err=float((dec - syms_flat).abs().max().item()),
                              ms=dec_ms, plain_ms=dec_plain_ms,
                              bound=bound(4 * n_words + 4 * B * n, flops, H100_BF16_FLOPS),
                              library_ms=None)
        floor_ms = [operand_bytes(sched, B, kf, L, p, dec, n_words) / H100_BYTES_PER_S * 1e3
                    for dec in (False, True)]
        print(f'[10 precision {prec}] container prec {p}, B={B} {IMG_H}x{IMG_W} latent {shape}: '
              + roundtrip_line(rt) + f' (a second pass: entropy_encode {warm[1]:.3f}, '
              f'entropy_decode {warm[2]:.3f})'
              + f'; bpp {100 * (rt["bpp"] / bpp0 - 1):+.4f}% and '
              f'theory {100 * (rt["theo_bpp"] / theo0 - 1):+.4f}% against f32 on the same '
              f'symbols ({bpp0:.5f}); launches { {k: v for k, v in ran.items() if v} }; '
              f'kernel 2: layer-parallel encode (3a) '
              f'{enc_ms:.3f} ms, scan decode (3b) {dec_ms:.3f} ms (on clusters of 8, 4, 2 and '
              f'1 too: the same symbols); tables equal to the scan\'s mode-1 tables and to the plain version\'s ({plain_ms:.0f} ms) on all '
              f'{f_k.numel()} entries; the plain decode of the same streams recovers the '
              f'symbols ({dec_plain_ms:.0f} ms); operands at their storage types written '
              f'and read once over the HBM rate (computed, operand_bytes): 3a '
              f'{floor_ms[0]:.3f} ms, 3b {floor_ms[1]:.3f} ms'
              + (f'; ProbClassifier.logits in bf16 {lib_ms:.3f} ms' if lib_ms else ''),
              flush=True)

    # kf = 64 (weights in device memory) and kf = 8 (the generic instance).
    L = pc.num_centers
    sub = syms[:2]
    sub_flat = syms_flat[:2]
    for label, spec, kf in (('kf=64', 'cvpr/res_shallow_64', None),
                            ('kf=8 (generic)', 'cvpr/res_shallow', 8)):
        cfg, _ = config_lib.parse_spec(spec, 'pc')
        if kf:
            cfg = cfg.replace(arch_param__k=kf)
        pcx = pc_lib.init_params(pc_lib.ProbClassifier(cfg, L, device=dev), seed=0)
        fwx = cuda_codec.fold_weights(pcx, centers)
        out = []
        for prec in ck.PRECS[1:]:
            p = ck.prec_id(prec)
            (f_k, s_k), (f_s, s_s), enc_ms, dec_ms, dec = k3_kernel_times(fwx, shape, sub_flat,
                                                                          prec=p)
            f_p, s_p = ck.wavefront_encode_plain(fwx, shape, sub_flat, prec=p)
            if not (torch.equal(f_k, f_s) and torch.equal(s_k, s_s)
                    and torch.equal(f_k, f_p) and torch.equal(s_k, s_p)):
                raise AssertionError(f'10 {label} {prec}: tables differ from the scan\'s or '
                                     'the plain version\'s')
            lc = codec_lib.LatentCodec(pcx, cfg, device=dev, prec=prec)
            res = lc.encode_batch(sub, centers)
            got = lc.decode_batch([r.bitstream for r in res], centers, verify=True)
            if not (torch.equal(dec, sub_flat) and torch.equal(got.long(), sub.long())):
                raise AssertionError(f'10 {label} {prec}: round trip not bit-exact')
            if {codec_lib.stream_prec(r.bitstream) for r in res} != {p}:
                raise AssertionError(f'10 {label} {prec}: wrong prec byte')
            out.append(f'{prec}: encode {enc_ms:.3f} ms, decode {dec_ms:.3f} ms')
        place = 'device memory' if ck.weights_in_device(fwx.w2.shape[-1], L, sched.CQ, sched.T,
                                                        prec=1) else 'shared memory'
        print(f'[10 precision {label}] seeded pc {spec}, B=2 latent {shape}, scan weights in '
              f'{place}: at bf16 and f8 the layer-parallel tables equal the scan\'s and the '
              f'plain version\'s on every entry, the round trips are CRC-verified bit-exact '
              f'with their prec byte; ' + '; '.join(out), flush=True)

    # Every precision writes the parent's bytes.
    os.makedirs(PREC_ROOT, exist_ok=True)
    digests = {}
    env0 = os.environ.get(cuda_codec.PREC_ENV)
    try:
        for (impl, prec), want in AB_DIGESTS.items():
            path = os.path.join(PREC_ROOT, f'ab_{impl}_{prec}.pkl')
            os.environ[cuda_codec.PREC_ENV] = prec
            with contextlib.redirect_stdout(io.StringIO()):
                ab_streams.main(['dump', '--impl', impl, '--k', '3' if impl == 'cuda' else '5',
                                 '--out', path])
            with open(path, 'rb') as f:
                d = pickle.load(f)
            got = digests[impl, prec] = d['cases'][1]['digest']
            if d.get('prec', 0) != ck.prec_id(prec) or got != want:
                raise AssertionError(f'10: {impl} {prec} streams moved: digest {got}, the '
                                     f'parent\'s {want}')
    finally:
        if env0 is None:
            os.environ.pop(cuda_codec.PREC_ENV, None)
        else:
            os.environ[cuda_codec.PREC_ENV] = env0
    print(f'[10 precisions 0-2] ab_streams\' workload (latent (16, 24, 36), batch 8, seeded): '
          f'the K=3 (id 5) streams at prec 0, 1 and 2 and the K=5 (id 6) prec-0 streams are '
          f'the parent commit\'s bytes (sha256 '
          + ', '.join(f'{i} {pr} {v[:16]}...' for (i, pr), v in digests.items())
          + f'); phase {time.time() - t_phase:.1f} s', flush=True)
    return launches


def scaled_copy(pc, conv_name, scale, channel=None):
    """A copy of context model ``pc`` with conv ``conv_name``'s weights and
    bias (output channel ``channel`` only, when given) times ``scale``, in
    float64 and rounded once."""
    import copy
    import torch
    out = copy.deepcopy(pc)
    conv = getattr(out.net, conv_name)
    with torch.no_grad():
        for t in (conv.weight, conv.bias):
            part = t if channel is None else t[channel]
            part.copy_((part.double() * scale).float())
    return out


def all_ones_columns(logits):
    """(..., L) logits -> bool (...): the cells whose column is freq 1 for
    every symbol (a NaN or +inf logit there), by the plain CDF."""
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
    return (ck.logits_to_cdf(logits)[0] == 1).all(-1)


def nonfinite_path(dev, pc, pc_config, pc5, pc5_config, centers, rt4, val_info):
    """Phase 10, non-finite inputs. K=3: the trained model with layer 1's
    hottest output channel scaled until its largest activations on phase 4's
    first two images pass 464, which the f8 ring rounds to NaN (XLA's
    rule): kernel 2's f8 layer-parallel tables, its scan's mode-1 tables and
    its plain version's equal on every entry, the cells whose column is all
    ones counted (fail at 0) and coded at freq 1, start = symbol; the f8
    round trip CRC-verified. K=5: phase 5's seeded pc base with its last
    layer scaled until its largest logits pass float32's range (+inf, so NaN
    columns through inf - inf): kernel 5's layer-parallel tables, its scan's
    and its plain version's equal on every entry, the same count, the round
    trip. Then, recorded and not held: phase 7's K=5 checkpoint encoded
    outside cuDNN's deterministic scope and decoded inside it, and the other
    way round (CRC, symbols and table entries off)."""
    import torch
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib, cuda_codec
    from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck, planar_codec
    from imgcomp_cvpr_tpu_torch.coding import planar_kernel as plk
    from imgcomp_cvpr_tpu_torch.eval import validate as validate_lib
    from imgcomp_cvpr_tpu_torch.training import checkpoint as checkpoint_lib
    from imgcomp_cvpr_tpu_torch.utils import logdir as logdir_lib
    t_phase = time.time()
    syms = rt4['syms'][:2].int().contiguous()
    B, C, H, W = syms.shape
    shape, n = (C, H, W), C * H * W
    flat = syms.reshape(B, n).contiguous()

    # K=3 at f8: scale layer 1's hottest channel to 1.25 x 464 at its peak.
    fw = cuda_codec.fold_weights(pc, centers)
    tabs = ck.device_tables(shape, str(dev))
    src = torch.cat([fw.centers[flat.long()], fw.pad.expand(B, 1)], 1)[:, :, None]
    peak = ck.layer_all_cells(src, tabs.taps[0].long(), fw.w1, fw.b1).amax((0, 1))
    ch = int(peak.argmax())
    scale = 1.25 * 464 / float(peak[ch])
    hot = scaled_copy(pc, 'conv0', scale, ch)
    fwh = cuda_codec.fold_weights(hot, centers)
    src = torch.cat([fwh.centers[flat.long()], fwh.pad.expand(B, 1)], 1)[:, :, None]
    past = int((ck.layer_all_cells(src, tabs.taps[0].long(), fwh.w1, fwh.b1) > 464).sum())
    (f_k, s_k), (f_s, s_s), enc_ms, dec_ms, dec = k3_kernel_times(fwh, shape, flat, prec=2)
    (f_p, s_p), logits = ck.wavefront_encode_plain(fwh, shape, flat, prec=2,
                                                   return_logits=True)
    if not (torch.equal(f_k, f_s) and torch.equal(s_k, s_s)):
        raise AssertionError('10 non-finite K=3 f8: tables differ from the scan\'s')
    if not (torch.equal(f_k, f_p) and torch.equal(s_k, s_p)):
        raise AssertionError('10 non-finite K=3 f8: tables differ from the plain version\'s')
    if not torch.equal(dec, flat):
        raise AssertionError('10 non-finite K=3 f8: the scan did not recover the symbols')
    ones = all_ones_columns(logits)
    idx = tabs.idx_cm.long()
    act = idx < n
    idx_c = idx.clamp(max=n - 1)
    at = ones[:, idx_c] & act
    if int(ones.sum()) == 0:
        raise AssertionError('10 non-finite K=3 f8: no all-ones column: the case is not driven')
    if not (torch.equal(f_k[at], torch.ones_like(f_k[at]))
            and torch.equal(s_k[at], flat[:, idx_c][at])):
        raise AssertionError('10 non-finite K=3 f8: an all-ones column not coded at freq 1, '
                             'start = symbol')
    lc = codec_lib.LatentCodec(hot, pc_config, device=dev, prec='f8')
    res = lc.encode_batch(syms, centers)
    got = lc.decode_batch([r.bitstream for r in res], centers, verify=True)
    if not torch.equal(got.long(), syms.long()):
        raise AssertionError('10 non-finite K=3 f8: round trip not bit-exact')
    print(f'[10 non-finite K=3 f8] trained pc cvpr/res_shallow with layer 1\'s channel {ch} '
          f'x {scale:.4f} (its peak {float(peak[ch]):.3f} -> {1.25 * 464:.0f}), B={B} latent '
          f'{shape}: {past} layer-1 activations past 464; {int(ones.sum())} of {ones.numel()} '
          f'cells with an all-ones column ({int((~torch.isfinite(logits)).any(-1).sum())} '
          f'with a non-finite logit); kernel 2\'s f8 layer-parallel tables equal the scan\'s '
          f'mode-1 tables and the plain version\'s on all {f_k.numel()} entries, the '
          f'all-ones cells coded at freq 1, start = symbol; the scan decodes kernel 3\'s '
          f'streams; 3a {enc_ms:.3f} ms, 3b {dec_ms:.3f} ms; LatentCodec(prec=\'f8\') round '
          f'trip CRC-verified bit-exact ({sum(r.num_bits for r in res)} bits)', flush=True)

    # csrc/cdf.cuh on logits given outright (kernel 5's table pass): a seed
    # puts NaN, +inf and -inf in 5% of the cells each, one symbol each.
    coder = planar_codec.PlanarCoder(pc5, pc5_config, device=dev)
    fold = coder._prepare(shape, centers)[1]
    L = pc5.num_centers
    rng = np.random.RandomState(0)
    lg = (rng.randn(B * C, H, W, L) * 4).astype(np.float32)
    for v, cells in zip((np.nan, np.inf, -np.inf), rng.rand(3, B * C, H, W) < 0.05):
        lg[cells, rng.randint(0, L, int(cells.sum()))] = v
    lg = torch.from_numpy(lg).to(dev)
    true = syms.reshape(B * C, H, W).contiguous()
    ft, st = plk.plane_tables(fold.top, lg, true, shape, coder.K)
    fp, sp = plk.plane_tables_plain(lg, true, shape, coder.K)
    if not (torch.equal(ft, fp) and torch.equal(st, sp)):
        raise AssertionError('10 non-finite: kernel 5\'s table pass differs from the plain '
                             'version on non-finite logits')
    n_cdf = int(all_ones_columns(lg).sum())
    print(f'[10 non-finite CDF] kernel 5\'s table pass on seeded logits (B*C={B * C} planes '
          f'of {H}x{W}, a NaN, a +inf or a -inf in 5% of the cells each): {n_cdf} all-ones '
          f'columns; tables equal to the plain version\'s on all {ft.numel()} entries '
          f'((int)floorf(NaN) is 0 on the card, no deficit on a NaN column)', flush=True)

    # K=5: the last layer scaled until its largest logits pass float32's range.
    _, lg = coder.encode_tables(syms, fold, plain=True, return_logits=True)
    scale5 = 1.25 * float(np.finfo(np.float32).max) / float(lg.max())
    hot5 = scaled_copy(pc5, 'conv_out', scale5)
    coder = planar_codec.PlanarCoder(hot5, pc5_config, device=dev)
    fold = coder._prepare(shape, centers)[1]
    fk5, sk5 = coder.encode_tables(syms, fold)
    fs5, ss5 = coder.encode_tables_scan(syms, fold)
    (fp5, sp5), lg = coder.encode_tables(syms, fold, plain=True, return_logits=True)
    if not (torch.equal(fk5, fs5) and torch.equal(sk5, ss5)):
        raise AssertionError('10 non-finite K=5: tables differ from the scan\'s')
    if not (torch.equal(fk5, fp5) and torch.equal(sk5, sp5)):
        raise AssertionError('10 non-finite K=5: tables differ from the plain version\'s')
    ones5 = all_ones_columns(lg)
    n_inf = int((lg == float('inf')).sum())
    if n_inf == 0 or int(ones5.sum()) == 0:
        raise AssertionError(f'10 non-finite K=5: {n_inf} +inf logits, {int(ones5.sum())} '
                             'all-ones columns: the case is not driven')
    lc5 = codec_lib.LatentCodec(hot5, pc5_config, device=dev)
    res5 = lc5.encode_batch(syms, centers)
    got5 = lc5.decode_batch([r.bitstream for r in res5], centers, verify=True)
    if not torch.equal(got5.long(), syms.long()):
        raise AssertionError('10 non-finite K=5: round trip not bit-exact')
    print(f'[10 non-finite K=5] seeded pc base with conv_out x {scale5:.6g} (float32\'s max '
          f'over 0.8 of its peak logit), B={B} latent {shape}: {n_inf} +inf logits, '
          f'{int(ones5.sum())} of {ones5.numel()} cells with an all-ones column; kernel 5\'s '
          f'layer-parallel tables equal the scan\'s mode-1 tables and the plain version\'s '
          f'on all {fk5.numel()} entries; round trip CRC-verified bit-exact '
          f'({sum(r.num_bits for r in res5)} bits)', flush=True)

    # Phase 7's K=5 checkpoint across cuDNN's deterministic scope: recorded.
    em = validate_lib.build_eval_model_from_log_dir(val_info['log5'], device=dev)
    ckpt_dir = logdir_lib.ckpt_dir_for_log_dir(val_info['log5'])
    em.set_params(checkpoint_lib.Saver(ckpt_dir).restore(9000)[0]['model'])
    syms4 = rt4['syms'][:4].int().contiguous()
    c5 = em.ae.encoder.centers.detach()
    lc5 = codec_lib.LatentCodec(em.pc, em.pc_config, device=dev)
    coder = planar_codec.PlanarCoder(em.pc, em.pc_config, device=dev)
    fold = coder._prepare(tuple(syms4.shape[1:]), c5)[1]

    def scoped(on, fn):
        with (validate_lib.deterministic_cudnn() if on else contextlib.nullcontext()):
            return fn()

    tables = {on: scoped(on, lambda: coder.encode_tables(syms4, fold)) for on in (False, True)}
    off = int(((tables[False][0] != tables[True][0])
               | (tables[False][1] != tables[True][1])).sum())
    out = []
    for enc_on in (False, True):
        streams = [r.bitstream for r in scoped(enc_on, lambda: lc5.encode_batch(syms4, c5))]
        try:
            got = scoped(not enc_on, lambda: lc5.decode_batch(streams, c5, verify=True))
            crc = 'CRC pass'
        except ValueError:
            got = scoped(not enc_on, lambda: lc5.decode_batch(streams, c5, verify=False))
            crc = 'CRC FAIL'
        wrong = int((got.long() != syms4.long()).sum())
        out.append(f'encoded {"inside" if enc_on else "outside"}, decoded '
                   f'{"outside" if enc_on else "inside"}: {crc}, {wrong} of {syms4.numel()} '
                   f'symbols off')
    print(f'[10 cudnn scopes] phase 7\'s K=5 checkpoint (seeded pc base), phase 4\'s first 4 '
          f'images\' symbols, LatentCodec: ' + '; '.join(out) + f'; encode tables outside '
          f'against inside the scope: {off} of {tables[False][0].numel()} entries off '
          f'(recorded, not held); phase {time.time() - t_phase:.1f} s', flush=True)


def entry_points(dev):
    """Phase 11: graft_entry_torch's entry points on the card, the launch
    counts set to 0 just before and read just after. entry(): one forward
    step of the seeded flagship model on a 64x64 image, against the same
    step on the CPU (symbols within the AE parity bound of 0.1%, and where
    they agree, x_out within 1e-2 and bpp within 1e-5 relative);
    dryrun_multichip(1): one data-parallel train step (NCCL, world 1),
    EvalModel and a LatentCodec round trip of 2 latents on the card.
    Returns the launch counts."""
    import copy
    import io
    import torch
    import graft_entry_torch as entry_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build
    t_phase = time.time()
    torch.cuda.synchronize()
    build.reset_launches()
    fn, (ae, pc, x) = entry_lib.entry()
    out, bpp = fn(ae, pc, x)
    with torch.no_grad():
        sym = ae.encode(x).symbols
    torch.cuda.synchronize()
    ae_c, pc_c = copy.deepcopy(ae).cpu(), copy.deepcopy(pc).cpu()
    out_c, bpp_c = fn(ae_c, pc_c, x.cpu())
    with torch.no_grad():
        sym_c = ae_c.encode(x.cpu()).symbols
    flips = int((sym.cpu() != sym_c).sum().item())
    if tuple(out.shape) != (1, 64, 64, 3) or not torch.isfinite(out).all():
        raise AssertionError(f'11 entry: bad output {tuple(out.shape)}')
    if flips > 1e-3 * sym.numel():
        raise AssertionError(f'11 entry: {flips} of {sym.numel()} symbols differ from the CPU')
    err = (out.cpu() - out_c).abs().max().item()
    rel = abs(float(bpp) / float(bpp_c) - 1)
    if flips == 0 and (err > 1e-2 or rel > 1e-5):
        raise AssertionError(f'11 entry: x_out err {err}, bpp rel {rel} against the CPU')
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        entry_lib.dryrun_multichip(1)
    line = buf.getvalue().strip().splitlines()[-1]
    if not line.startswith('dryrun_multichip(1): ok'):
        raise AssertionError(f'11 dryrun_multichip(1): {line}')
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for name in ('quantize', 'quantize_bwd', 'wavefront_forward_encode',
                 'wavefront_forward_decode', 'rans_reverse'):
        if launches[name] < 1:
            raise AssertionError(f'11: kernel {name} was not launched by the entry points')
    print(f'[11 entry points] entry(): x_out {tuple(out.shape)}, bpp {float(bpp):.6f}; against '
          f'the CPU: {flips} of {sym.numel()} symbols differ, x_out max abs err {err:.3g}, '
          f'bpp rel {rel:.3g}; {line}; launches '
          f'{ {k: v for k, v in launches.items() if v} }; phase {time.time() - t_phase:.1f} s',
          flush=True)
    return launches


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card (torch.cuda.is_available() is False)',
              file=sys.stderr)
        return 2
    root = argv[argv.index('--root') + 1] if '--root' in argv else None
    if '--quantizer-only' in argv:
        return quantizer_only(root)
    if '--kernel2-only' in argv:
        return kernel2_only(root, '--profile' in argv)
    if '--bias-rows-only' in argv:
        return bias_rows_only()
    from imgcomp_cvpr_tpu_torch import weights as weights_lib
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib
    from imgcomp_cvpr_tpu_torch.coding import cuda_codec, cuda_kernel as ck
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
    from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
    from imgcomp_cvpr_tpu_torch.ops.kernels import build, quantize as qk
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib

    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    def nvidia_smi(query):
        return subprocess.run(['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]

    smi = nvidia_smi('name,power.limit')
    print(smi, flush=True)
    sm_mhz = int(nvidia_smi('clocks.max.sm').split()[0])
    print(f'[1 device] torch: {kind}; nvidia-smi: {smi}, top SM clock {sm_mhz} MHz; torch '
          f'{torch.__version__} cuda {torch.version.cuda}', flush=True)

    t0 = time.time()
    logs = build.build_all()
    regs = '; '.join(f'{k}: ' + ' | '.join(ptxas_summary(v)) for k, v in logs.items())
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
    qt = quantizer_times(lambda: qk.quantize_fwd(z, centers), 'quantize_fwd')
    rows['quantize'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/quantize.cu',
        replaces='imgcomp_cvpr_tpu/ops/pallas/quantize.py:147',
        max_abs_err=q_err, ms=qt['device_ms'] or qt['graph_ms'], quantizer=qt,
        plain_ms=cuda_ms(lambda: qk.quantize_plain(z, centers), 5),
        bound=bound(16 * nz, 9 * 6 * nz), library_ms=None)
    print(f'[3 quantize] z {tuple(z.shape)}: symbols equal, qsoft max abs err '
          f'{q_err:.3g} (tol 1e-5); '
          + quantizer_line('times', qt, bound(16 * nz, 9 * 6 * nz)[0]), flush=True)
    quantize_bwd_kernel(dev, centers, rows)

    macs = 0
    for li, layer in enumerate(sched.layers):
        cin = 1 if li == 0 else fw.w2.shape[1]
        cout = fw.w4.shape[-1] if li == 3 else fw.w2.shape[-1]
        macs += layer.taps.shape[0] * layer.taps.shape[1] * cin * cout
    fwd_flops = 2 * macs * BATCH
    act = torch.from_numpy(sched.idx_cm < n).to(dev)
    f_k, s_k = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=syms_flat)
    f_s, s_s = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=syms_flat, scan=True)
    if not (torch.equal(f_k, f_s) and torch.equal(s_k, s_s)):
        raise AssertionError('forward encode: layer-parallel tables differ from the '
                             'scan\'s mode-1 tables')
    enc_plain_ms, (f_p, s_p) = host_ms(lambda: ck.wavefront_encode_plain(
        fw, shape, syms_flat))
    flips = int((((f_k != f_p) | (s_k != s_p)) & act).sum().item())
    entries = int(act.sum().item()) * BATCH
    if flips > 1e-3 * entries:
        raise AssertionError(f'forward encode: {flips} flips > 0.1% of {entries}')
    table_bytes = 2 * 4 * BATCH * sched.T * sched.CQ
    kf3, L3 = fw.w2.shape[-1], fw.w4.shape[-1]
    chosen = ck.scan_cluster(kf3, L3, sched.CQ, sched.T, BATCH)
    scan_enc = {c: cuda_ms(lambda: ck.wavefront_forward(
        ck.MODE_ENCODE, fw, shape, true_syms=syms_flat, scan=True, cluster=c))
        for c in (chosen, 1)}
    lib3_ms = library_logits_ms(pc, centers, syms)
    rows['wavefront_forward_encode'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/wavefront_forward.cu',
        replaces='imgcomp_cvpr_tpu/coding/pallas_kernel.py:1089',
        max_abs_err=float(((f_k - f_p).abs() * act).max().item()),
        ms=cuda_ms(lambda: ck.wavefront_forward(ck.MODE_ENCODE, fw, shape,
                                                true_syms=syms_flat), 3),
        plain_ms=enc_plain_ms,
        bound=bound(4 * BATCH * n + table_bytes, fwd_flops), library_ms=lib3_ms)
    print(f'[3 forward encode] layer-parallel tables (5 launches, '
          f'{rows["wavefront_forward_encode"]["ms"]:.3f} ms) equal to the scan\'s mode-1 '
          f'tables on all {f_k.numel()} entries (scan: {scan_enc[chosen]:.3f} ms over clusters '
          f'of {chosen} blocks, {scan_enc[1]:.3f} ms with one block an image); vs the plain '
          f'layer-at-a-time version: {flips} boundary flips of {entries} active entries '
          f'(tol 0.1%); ProbClassifier.logits (F.conv3d, f32, TF32 off, logits only: no '
          f'CDF, no selection) on the same symbols {lib3_ms:.3f} ms', flush=True)

    x0 = 1
    (w_k, n_k, st_k, k_k), (w_p, n_p, _, _), rev_plain_ms, rev_ms, stats = reverse_kernel(
        'rans_reverse', lambda f, s, x, prof=None: ck.rans_reverse(f, s, shape, x, prof),
        lambda f, s, x: ck.rans_reverse_plain(f, s, shape, x), f_k, s_k, x0, sm_mhz)
    rows['rans_reverse'] = dict(
        route='cuda', source='imgcomp_cvpr_tpu_torch/csrc/rans_reverse.cu',
        replaces='imgcomp_cvpr_tpu/coding/pallas_kernel.py:1362',
        max_abs_err=float(max((w_k[i, :n_k[i]] - w_p[i, :n_p[i]]).abs().max().item()
                              for i in range(BATCH) if n_k[i] > 0)),
        ms=rev_ms, plain_ms=rev_plain_ms,
        bound=bound(table_bytes + 4 * int(n_k.sum().item()) + 8 * 32 * BATCH, 0),
        library_ms=None)
    print(reverse_line('rans_reverse', BATCH, int(n_k.sum().item()), rev_ms, stats, sm_mhz),
          flush=True)

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
    dec_ms = {}
    for c in (8, 6, 4, 2, 1):
        out_c = ck.wavefront_forward(ck.MODE_DECODE, fw, shape, streams=streams,
                                     init_states=st_k, thresh=thresh, cluster=c)
        if not torch.equal(out_c, syms_flat):
            raise AssertionError(f'forward decode: cluster of {c} did not recover the symbols')
        dec_ms[c] = cuda_ms(lambda: ck.wavefront_forward(
            ck.MODE_DECODE, fw, shape, streams=streams, init_states=st_k, thresh=thresh,
            cluster=c))
    occupancy = {c: ck.max_active_clusters(kf3, L3, sched.CQ, sched.T, c)
                 for c in range(1, ck.MAX_CLUSTER + 1)}
    prof = torch.zeros(BATCH, 10, dtype=torch.int64, device=dev)
    ck.wavefront_forward(ck.MODE_DECODE, fw, shape, streams=streams, init_states=st_k,
                         thresh=thresh, prof=prof)
    clocks = (prof.double().mean(0) / sched.T).round().long().tolist()
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
    adds3 = 13 + 3 * 14 * kf3
    print(f'[3 forward decode] kernel (every cluster size) and plain version each recover '
          f'the teacher symbols exactly from their own streams; ms by blocks an image: '
          f'{ {c: round(t, 3) for c, t in dec_ms.items()} } (the path takes {chosen} for '
          f'B={BATCH}: the largest cluster of which the card holds {BATCH} at once; '
          f'cudaOccupancyMaxActiveClusters by cluster size: {occupancy}); clocks a step on '
          f'clusters of {chosen}, mean over the images (layer 1, barrier, layer 2, barrier, '
          f'layer 3, barrier, layer 4, barrier, CDF + rANS, barrier): {clocks}; chain floor {chain_floor_ms(adds3, sched.T, sm_mhz):.3f} ms '
          f'({adds3} dependent adds a step x {sched.T} steps x {FADD_LATENCY_CLOCKS} clocks '
          f'at {sm_mhz} MHz)', flush=True)

    pc5_config, _ = config_lib.parse_spec('base', 'pc')
    pc5 = pc_lib.init_params(pc_lib.ProbClassifier(pc5_config, ae_config.num_centers,
                                                   device=dev), seed=0)
    lc5 = codec_lib.LatentCodec(pc5, pc5_config, device=dev)
    planar_kernels(dev, syms, centers, pc5, pc5_config, rows, sm_mhz)
    bias_rows_kernel(dev, syms, centers, pc5, pc5_config, rows)

    # ---- phase 3b: any batch size, and streams that do not depend on it ----
    syms17 = torch.cat([syms, syms[:1]])
    for name, codec in (('K=3', lc), ('K=5', lc5)):
        streams_b = {}
        for b in (1, 3, 17):
            res = codec.encode_batch(syms17[:b], centers)
            dec_b = codec.decode_batch([r.bitstream for r in res], centers, verify=True)
            if not torch.equal(dec_b.long(), syms17[:b].long()):
                raise AssertionError(f'{name}: decode of B={b} did not recover the symbols')
            streams_b[b] = [r.bitstream for r in res]
        ones = [codec.encode_batch(syms17[i:i + 1], centers)[0].bitstream for i in range(3)]
        if streams_b[3] != ones or streams_b[17][:3] != ones or streams_b[1][0] != ones[0]:
            raise AssertionError(f'{name}: B=3 streams differ from B=1 streams')
        print(f'[3b batch invariance] {name}: B = 1, 3 and 17 images decode to their '
              f'symbols (CRC verified); the B=3 (and the first three B=17) streams are '
              f'byte-identical to B=1 streams', flush=True)

    # ---- phases 4 and 5: the main paths through the entry points ---------
    launches = {}
    for phase, codec in ((4, lc), (5, lc5)):
        launches[phase], rt = main_path(ae, codec, x, centers)
        if not rt['psnr'] > 15.0:
            raise AssertionError(f'main path {phase}: reconstruction PSNR {rt["psnr"]:.2f} dB')
        model = ('K=3 trained pc cvpr/res_shallow' if phase == 4
                 else 'K=5 seeded pc base, impl id 6')
        print(f'[{phase} main path] {model}, B={BATCH} {IMG_H}x{IMG_W} latent {shape}: '
              + roundtrip_line(rt), flush=True)
        if phase == 4:
            one_pass_mps, rt4 = rt['mp'] / rt['wall'], rt

    # ---- phase 4c: the serving path of bench_torch.py --------------------
    launches['4c'] = serving_path(dev, ae_config, ae, lc, lc5, pc, pc_config, pc5, pc5_config,
                                  x, centers, one_pass_mps)

    # ---- phase 4d: the AE's fused conv epilogue on the main path ---------
    launches['4d'] = ae_epilogue_path(dev, ae_config, ae, lc, x, centers, rows)

    # ---- phase 4b: context models past shared memory (kf = 64) -----------
    launches['4b'] = wide_context_models(dev, ae, ae_config, x, centers, fw)

    launches[6], step_ms6 = training_path(dev, rows)

    # ---- phase 7: the validation path -------------------------------------
    launches[7], val_info = validation_path(dev)

    # ---- phase 8: the tools ------------------------------------------------
    launches[8] = tools_path(dev, val_info)

    # ---- phase 9: data-parallel training and validation --------------------
    launches[9] = parallel_path(dev, val_info, step_ms6)

    # ---- phase 10: kernel 2 at bf16 and f8 (container prec 1 and 2) -------
    launches[10] = precision_path(dev, ae, pc, pc_config, x, centers, rt4, rows)
    nonfinite_path(dev, pc, pc_config, pc5, pc5_config, centers, rt4, val_info)

    # ---- phase 11: the entry points of graft_entry_torch.py ---------------
    launches[11] = entry_points(dev)

    kernels = []
    for phase, name in ((4, 'quantize'), (6, 'quantize_train'), (6, 'quantize_bwd'),
                        (4, 'wavefront_forward_encode'),
                        (4, 'wavefront_forward_decode'), (4, 'rans_reverse'),
                        (5, 'plane_forward_encode'), (5, 'plane_forward_decode'),
                        (5, 'plane_reverse'), (5, 'bias_rows'), ('4d', 'ae_epilogue')):
        # quantize_train is kernel 1 again: the wrapper's one counter, as
        # the training phase read it.
        n_launch = launches[phase]['quantize' if name == 'quantize_train' else name]
        if n_launch < 1 or (name == 'quantize' and launches[5][name] < 1):
            raise AssertionError(f'kernel {name} was not launched on main path {phase}')
        if name == 'plane_forward_encode' and n_launch > 5:
            raise AssertionError(f'kernel 5 encode took {n_launch} launches a batch')
        if name == 'bias_rows' and n_launch != 4 + shape[0]:
            raise AssertionError(f'bias rows: {n_launch} launches a K=5 round trip, not '
                                 f'4 + {shape[0]}')
        if name == 'ae_epilogue' and (launches[4][name], launches[5][name],
                                      launches[9]['train'][name]) != (70, 70, 0):
            raise AssertionError(f'ae_epilogue: {launches[4][name]} and {launches[5][name]} '
                                 f'launches on main paths 4 and 5 (not 70), '
                                 f'{launches[9]["train"][name]} in 9b\'s train steps (not 0)')
        r = rows[name]
        b_ms, b_by = r.pop('bound')
        kernels.append(dict(name=name, route=r['route'], source=r['source'],
                            replaces=r['replaces'], launches=n_launch,
                            max_abs_err=r['max_abs_err'], ms=r['ms'],
                            plain_ms=r['plain_ms'], bound_ms=b_ms, bound_by=b_by,
                            library_ms=r['library_ms']))
        if name in launches[7]:     # the validation path's own run (phase 7)
            kernels[-1]['launches_validation'] = launches[7][name]
        if name not in ('quantize_train', 'quantize_bwd'):      # the tools' run (phase 8)
            kernels[-1]['launches_tools'] = launches[8][name]
        # phase 9's data-parallel runs: the train steps (kernels 1 and 7), the
        # validation (kernels 1, 2, 3, 5, 6)
        kernels[-1]['launches_parallel'] = (
            launches[9]['train']['quantize' if name == 'quantize_train' else name]
            if name in ('quantize_train', 'quantize_bwd') else launches[9]['val'][name])
        if 'passes' in r:       # the AE epilogue: phase 4d by pass and call
            kernels[-1]['passes'] = r['passes']
        if 'quantizer' in r:    # kernels 1 and 7: device time beside the host's
            q = r['quantizer']
            kernels[-1].update(device_ms=q['device_ms'], graph_ms=q['graph_ms'],
                               host_us_per_call=q['host_us_per_call'],
                               launches_per_call=q['launches_per_call'])
        if name in launches[11]:    # the entry points' run (phase 11)
            kernels[-1]['launches_entry'] = launches[11][name]
    # Kernel 2 at bf16 and f8: launches from phase 10's main path of each.
    for prec in ck.PRECS[1:]:
        for base in ('wavefront_forward_encode', 'wavefront_forward_decode'):
            name = ck.launch_name(base, prec)
            r = rows[name]
            b_ms, b_by = r.pop('bound')
            kernels.append(dict(name=name, route=r['route'], source=r['source'],
                                replaces=r['replaces'], launches=launches[10][prec][name],
                                max_abs_err=r['max_abs_err'], ms=r['ms'],
                                plain_ms=r['plain_ms'], bound_ms=b_ms, bound_by=b_by,
                                library_ms=r['library_ms']))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                            'count': torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
