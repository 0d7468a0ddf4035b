"""Per-stage codec profiling (port of imgcomp_cvpr_tpu/tools/profile_codec.py;
the reference's tracing/profiling analog, SURVEY.md §5; ref
train.py:243-276 used TF FULL_TRACE + img/s timers).

Times each stage of the encode+decode path separately on one CUDA card
(``--device cpu`` runs the plain versions) and prints a JSON report with the
JAX tool's keys: AE encode, kernel 2's layer-parallel encode (the forward
CDF tables, ``cdf_scan_s``), kernel 3 (the reverse rANS, ``reverse_rans_
scan_s``), the whole encode_batch and decode_batch (kernel 2's scan, the
container serialize and parse, the CRC checks), AE decode; plus the card
(nvidia-smi's name and power limit), each kernel's launches in the run and
kernel 2's operand precision (``prec``: $IMGCOMP_PALLAS_PREC, f32 when
unset, through the codec as the JAX tool's PallasCoder reads it).
A stage is timed with CUDA events around ``iters`` calls after one warm-up
(on the CPU, where nothing is built or cached, by the host clock without
one). ``--trace DIR`` writes a torch.profiler Chrome
trace of the run to DIR.

Model: random-init ``ae cvpr/low`` + ``pc cvpr/res_shallow`` (explicit
seeded generators: AE seed 0, context model seed 1), images
``np.random.RandomState(0).rand(B, H, W, 3) * 255``, as the JAX tool.

    python -m imgcomp_cvpr_tpu_torch.tools.profile_codec --batch 8
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .. import resolve_device


def _smi(dev: torch.device) -> str:
    if dev.type != 'cuda':
        return 'cpu'
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def profile(batch: int = 8, h: int = 512, w: int = 768, iters: int = 3,
            trace_dir: str = None, device='cuda') -> dict:
    from ..coding import codec as codec_lib
    from ..coding import cuda_codec
    from ..coding import cuda_kernel as ck
    from ..models import autoencoder as ae_lib
    from ..models import probclass as pc_lib
    from ..ops.kernels import build
    from ..utils import config as config_lib

    dev = resolve_device(device)
    ae_config, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc_config, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    ae = ae_lib.init_params(ae_lib.get_network_cls(ae_config)(ae_config, device=dev), 0)
    pc = pc_lib.init_params(pc_lib.ProbClassifier(pc_config, ae_config.num_centers,
                                                  device=dev), 1)
    codec = codec_lib.LatentCodec(pc, pc_config, device=dev)

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(batch, h, w, 3).astype(np.float32) * 255.0).to(dev)
    centers_dev = ae.encoder.centers.detach()
    centers = centers_dev.cpu().numpy()
    latent = (ae_config.num_chan_bn, h // 8, w // 8)

    def timed(fn, *args):
        if dev.type == 'cuda':
            fn(*args)                           # warm-up: kernel build, caches
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(iters):
                out = fn(*args)
            ev[1].record()
            ev[1].synchronize()
            return ev[0].elapsed_time(ev[1]) / 1e3 / iters, out
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        return (time.perf_counter() - t0) / iters, out

    report = {'batch': batch, 'image': [h, w],
              'megapixels': batch * h * w / 1e6,
              'device': _smi(dev)}

    prof = None
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile as torch_profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == 'cuda' else [])
        prof = torch_profile(activities=acts)
        prof.__enter__()
    launches0 = dict(build.LAUNCHES)

    t, enc = timed(ae.encode, x)
    report['ae_encode_s'] = round(t, 4)
    syms = enc.symbols.permute(0, 3, 1, 2).to(torch.int8).contiguous()   # (B, C, H, W)

    sched = ck.build_schedule(latent)
    fold = cuda_codec.fold_weights(pc, centers_dev)
    prec = cuda_codec.encode_prec()
    report['prec'] = ck.PRECS[prec]
    syms_flat = syms.reshape(batch, -1).int().contiguous()
    t, (fsel, ssel) = timed(lambda: ck.wavefront_forward(
        ck.MODE_ENCODE, fold, latent, true_syms=syms_flat, prec=prec))
    report['cdf_scan_s'] = round(t, 4)
    t, _ = timed(lambda: ck.rans_reverse(fsel, ssel, latent, 1))
    report['reverse_rans_scan_s'] = round(t, 4)

    t, results = timed(codec.encode_batch, syms, centers)
    report['encode_batch_total_s'] = round(t, 4)
    streams = [res.bitstream for res in results]
    t, decoded = timed(codec.decode_batch, streams, centers)
    report['decode_batch_total_s'] = round(t, 4)
    if not torch.equal(decoded.to(torch.int8), syms):
        raise AssertionError('decoded symbols differ from the encoded ones')

    t, _ = timed(ae.decode, enc.qhard)
    report['ae_decode_s'] = round(t, 4)

    if prof is not None:
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, 'profile_codec.trace.json'))

    total = (report['encode_batch_total_s'] + report['decode_batch_total_s']
             + report['ae_encode_s'] + report['ae_decode_s'])
    report['end_to_end_mp_per_s'] = round(report['megapixels'] / total, 3)
    report['steps_per_scan'] = sched.T
    report['lanes'] = sched.CQ          # the per-step table row (chunk-major)
    report['rans_lanes'] = ck.R
    report['launches'] = {k: n - launches0[k] for k, n in build.LAUNCHES.items()}
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--trace', help='Directory for a torch.profiler Chrome trace.')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises with no card) or 'cpu'.")
    flags = p.parse_args(argv)
    print(json.dumps(profile(batch=flags.batch, trace_dir=flags.trace,
                             device=flags.device), indent=1))


if __name__ == '__main__':
    main()
