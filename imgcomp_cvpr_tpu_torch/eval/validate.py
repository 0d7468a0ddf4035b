"""Validation loop (port of imgcomp_cvpr_tpu/eval/validate.py; ref:
val.py:40-212).

Sweeps checkpoints x images for one run: per image the cross-entropy bpp,
MS-SSIM and PSNR on the unpadded frame (and, with real_bpp, the entropy-coded
bpp through the port's LatentCodec, every shape bucket one batched encode and
one CRC-verified decode held bit-exact), writes measures.csv and
summary_<itr>.json, and records the validated iterations.

Images of one padded shape go through the model in batches of ``eval_batch``
(``iter_shape_buckets``). A tail batch is padded to ``eval_batch`` by
repeating its last image (``fetch_many``'s ``pad_batch_to``), so every batch
of a shape has one shape: cuDNN chooses its convolution algorithm by shape,
and with one shape an image's symbols and metrics do not depend on how many
other images share its batch. The pass runs with cuDNN's deterministic
algorithms: the decoder's transposed convolutions are cuDNN's backward-data
kernels, whose default algorithms sum in an order that changes from run to
run, which would move the output pixels, PSNR and MS-SSIM of the same
checkpoint between two validations.

While a torch profiler records, a pass's steps are spans
(``utils/spans.py``): ``record_function`` ranges named ``ic.val.<step>``
(upload, ae_encode, ae_decode, bitcost, msssim, psnr, to_host), so a
profiler trace of ``fetch_many`` splits its device time by step. With no
profiler recording they do not exist and cost one flag read each.

Data parallelism (the JAX package's mesh path, validate.py:115-127): an
EvalModel given a list of devices holds one copy of the model on each, pads
a batch to a multiple of their count by repeating its last image, runs one
equal piece on each device (all enqueued before any is read back) and drops
the pad rows; the real-bpp codec splits its batches over the same devices
(coding/codec.py). ``eval_batch`` is then the batch of each device: a bucket
holds eval_batch x devices images, so every device pass has the shape of a
one-device pass, and each image's results are those of a one-device run.
"""

from __future__ import annotations

import contextlib
import json
from collections import defaultdict
from os import makedirs, path
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.images_iterator import ImagesIterator
from ..models import autoencoder as ae_lib
from ..models import probclass as pc_lib
from ..ops import metrics as metrics_lib
from ..ops import msssim as msssim_lib
from ..training import checkpoint as checkpoint_lib
from ..utils import config as config_lib
from ..utils import constants
from ..utils import logdir as logdir_lib
from ..utils.spans import span
from . import codec_distance as cd
from .val_files import MeasuresWriter, ValidationDirs


class OutputFlags:
    def __init__(self, save_ours: bool = False, ckpt_step: int = -1,
                 real_bpp: bool = False, eval_batch: int = 8):
        self.save_ours = save_ours
        self.ckpt_step = ckpt_step
        self.real_bpp = real_bpp
        self.eval_batch = eval_batch


class EvalModel:
    """Per-image metrics of a fixed (ae, pc) config pair, on ``device``
    (raises for 'cuda' with no card), or on each device of a list (data
    parallel; see the module docstring). ``ae`` / ``pc`` are the copy on the
    first device."""

    def __init__(self, ae_config, pc_config, device='cuda'):
        self.ae_config = ae_config
        self.pc_config = pc_config
        devices = device if isinstance(device, (list, tuple)) else [device]
        self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]
        self._replicas = [
            (ae_lib.get_network_cls(ae_config)(ae_config, device=d),
             pc_lib.ProbClassifier(pc_config, ae_config.num_centers, device=d))
            for d in self.devices]
        self.ae, self.pc = self._replicas[0]

    def set_params(self, model: Dict) -> None:
        """``model`` is {'ae': state dict, 'pc': state dict}: the 'model'
        subtree of the checkpoints that training writes
        (TrainState.state_dict())."""
        for ae, pc in self._replicas:
            ae.load_state_dict(model['ae'], strict=True)
            pc.load_state_dict(model['pc'], strict=True)

    @torch.no_grad()
    def _fetch(self, replica, x_uint8: torch.Tensor, pad_info) -> Dict[str, torch.Tensor]:
        ae, pc = replica
        hp_lo, wp_lo, oh, ow = pad_info
        x = x_uint8.to(torch.float32)                 # (B, H, W, 3) padded frame
        # Metrics and saved outputs on the unpadded frame; bpp over its
        # pixel count too (the bits cover the padded latent, so pad rows
        # raise the bpp of an image whose sides are not multiples of 8).
        crop = (slice(None), slice(hp_lo, hp_lo + oh), slice(wp_lo, wp_lo + ow))
        with deterministic_cudnn():
            with span('val.ae_encode'):
                enc = ae.encode(x)
            with span('val.ae_decode'):
                x_out = ae.decode(enc.qhard)
            centers = ae.encoder.centers
            # bitcost from qbar at eval (ref: val.py:88)
            with span('val.bitcost'):
                bc = pc.bitcost(enc.qbar, enc.symbols,
                                pc_lib.auto_pad_value(self.pc_config, centers, pc))
            xc = x[crop]
            oc_uint8 = x_out.to(torch.uint8)[crop]
            oc = oc_uint8.to(torch.float32)
            with span('val.msssim'):
                msssim = torch.stack([msssim_lib.msssim_eval(xc[i:i + 1], oc[i:i + 1])
                                      for i in range(x.shape[0])])
        with span('val.psnr'):
            psnr = metrics_lib.psnr_per_image(xc, oc, cast_to_int=True)
        return {
            'bpp': bc.sum((1, 2, 3)) / float(oh * ow),
            'ms-ssim': msssim,
            'psnr': psnr,
            'sym': enc.symbols,
            'img_out': oc_uint8,
        }

    def fetch_many(self, imgs_hwc_uint8, pad_info=None,
                   pad_batch_to: int = 0) -> List[Dict[str, np.ndarray]]:
        """One device pass over same-shaped padded images (the reference runs
        one image a sess.run, ref val.py:158); returns one dict of host
        arrays per image: 'bpp', 'ms-ssim', 'psnr', 'sym' (NHWC int32
        symbols of the padded frame) and 'img_out' (HWC uint8). pad_info =
        (hp_lo, wp_lo, orig_h, orig_w) crops metrics and outputs to the
        unpadded frame (None: the whole frame). pad_batch_to pads the batch
        by repeating its last image, and so does a list of devices, to a
        multiple of their count; the pad results are dropped."""
        n_real = len(imgs_hwc_uint8)
        batch = np.stack(imgs_hwc_uint8)
        n = max(n_real, pad_batch_to)
        n = -(-n // len(self.devices)) * len(self.devices)
        if n > n_real:
            batch = np.concatenate([batch, np.repeat(batch[-1:], n - n_real, axis=0)])
        h, w = batch.shape[1:3]
        if pad_info is None:
            pad_info = (0, 0, h, w)
        per = n // len(self.devices)
        outs = []
        for i, (dev, replica) in enumerate(zip(self.devices, self._replicas)):
            with span('val.upload'):
                x = torch.from_numpy(batch[i * per:(i + 1) * per]).to(dev)
            outs.append(self._fetch(replica, x, tuple(pad_info)))
        with span('val.to_host'):
            out = {k: np.concatenate([o[k].cpu().numpy() for o in outs])[:n_real]
                   for k in outs[0]}
        return [{k: v[i] for k, v in out.items()} for i in range(n_real)]


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block (the previous
    setting comes back after it)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def build_eval_model_from_log_dir(log_dir: str, device='cuda') -> EvalModel:
    """Recover the configs from the log-dir name (config identity is part of
    checkpoint identity, ref: val.py:69-72)."""
    base_ae = constants.CONFIG_BASE_AE or path.join(config_lib.default_config_root(), 'ae')
    base_pc = constants.CONFIG_BASE_PC or path.join(config_lib.default_config_root(), 'pc')
    ae_path, pc_path = logdir_lib.config_paths_from_log_dir(
        log_dir, base_dirs=[base_ae, base_pc])
    ae_config, _ = config_lib.parse(ae_path, base_dir=base_ae)
    pc_config, _ = config_lib.parse(pc_path, base_dir=base_pc)
    return EvalModel(ae_config, pc_config, device=device)


def iter_shape_buckets(padded_iter, batch_size: int):
    """Group (name, img, pad_info) items into same-shape batches of up to
    batch_size, keyed by (padded shape, pad geometry): every image joins a
    full batch whatever the dataset's order. Memory stays bounded at
    #distinct-shapes x batch_size images. Yields (names, imgs, pad_info)."""
    buckets: Dict = {}
    for img_name, img, pad_info in padded_iter:
        key = (img.shape, pad_info)
        names, imgs = buckets.setdefault(key, ([], []))
        names.append(img_name)
        imgs.append(img)
        if len(imgs) >= batch_size:
            yield names, imgs, pad_info
            del buckets[key]
    for (_, pad_info), (names, imgs) in buckets.items():
        yield names, imgs, pad_info


class ValuesAggregator:
    def __init__(self, *tags):
        self.tags = tags
        self._values = defaultdict(list)

    def update(self, otp: Dict) -> None:
        for tag in self.tags:
            v = float(otp[tag])
            if np.isnan(v):
                raise ValueError(f'nan in {tag}')
            self._values[tag].append(v)

    def averages(self) -> Dict[str, float]:
        return {t: float(np.mean(v)) for t, v in self._values.items()}

    def averages_str(self) -> str:
        return ', '.join(f'{t}: {v:.3f}' for t, v in self.averages().items())


def validate(val_dirs: ValidationDirs, images_iterator: ImagesIterator,
             flags: OutputFlags, eval_model: Optional[EvalModel] = None,
             codec=None, device='cuda') -> None:
    """Validate the checkpoints of ``val_dirs`` not validated yet: every
    ``ckpt_step``-th and the last (-1: the last only). ``eval_model`` and
    ``codec`` (a LatentCodec for real_bpp) are built from the log dir's
    configs on ``device`` when not given."""
    validated = set(val_dirs.get_validated_checkpoints())
    all_ckpts = checkpoint_lib.all_ckpts_with_iterations(val_dirs.ckpt_dir)
    if not all_ckpts:
        print(f'No checkpoints found in {val_dirs.ckpt_dir}')
        return
    ckpts_to_check = all_ckpts[:-1:flags.ckpt_step] + [all_ckpts[-1]] \
        if flags.ckpt_step != -1 else [all_ckpts[-1]]
    missing = [(i, p) for i, p in ckpts_to_check if i not in validated]
    if not missing:
        print('All checkpoints validated, stopping...')
        return

    if eval_model is None:
        eval_model = build_eval_model_from_log_dir(val_dirs.log_dir, device=device)
    if flags.real_bpp and codec is None:
        from ..coding import codec as codec_lib
        # The real-bpp round trip runs a shape bucket at a time (the
        # reference entropy-codes one image per ~550 s, ref
        # bit_counter.py:13-74).
        codec = codec_lib.LatentCodec(eval_model.pc, eval_model.pc_config,
                                      device=eval_model.devices)

    saver = checkpoint_lib.Saver(val_dirs.ckpt_dir)
    last_itr = missing[-1][0]
    for ckpt_itr, _ in missing:
        print(f'- Validating ckpt {ckpt_itr} ----------')
        raw, _ = saver.restore(ckpt_itr)
        eval_model.set_params(raw['model'])
        # a host array keeps the codec's submits free of waits for the card
        centers = eval_model.ae.encoder.centers.detach().cpu().numpy()

        agg = ValuesAggregator('bpp', 'ms-ssim', 'psnr')
        measures_writer = MeasuresWriter(val_dirs.out_dir)
        img_counter = 0
        bucket = flags.eval_batch * len(eval_model.devices)
        try:
            for names, imgs, pad_info in iter_shape_buckets(
                    images_iterator.iter_padded(pad=ae_lib.SUBSAMPLING_FACTOR), bucket):
                outs = eval_model.fetch_many(imgs, pad_info=pad_info, pad_batch_to=bucket)
                num_pixels = pad_info[2] * pad_info[3]
                real_results = None
                if flags.real_bpp:
                    syms_batch = np.stack(
                        [np.transpose(o['sym'], (2, 0, 1)) for o in outs]
                    ).astype(np.int8)                      # NHWC -> NCHW
                    real_results = codec.encode_batch(syms_batch, centers)
                    decoded = codec.decode_batch([r.bitstream for r in real_results],
                                                 centers, verify=True, device_out=False)
                    np.testing.assert_array_equal(decoded, syms_batch.astype(np.int32))
                for i, (img_name, otp) in enumerate(zip(names, outs)):
                    measures_writer.append(img_name, {k: float(otp[k])
                                                      for k in ('bpp', 'ms-ssim', 'psnr')})
                    if real_results is not None:
                        bpp_real = real_results[i].num_bits / num_pixels
                        bpp_theory = real_results[i].theoretical_bits / num_pixels
                        bpp_loss = float(otp['bpp'])
                        print(f'BPP: Real         {bpp_real:.5f}\n'
                              f'     Theoretical: {bpp_theory:.5f} '
                              f'[{bpp_theory / bpp_real * 100:5.1f}% of real]\n'
                              f'     Loss:        {bpp_loss:.5f} '
                              f'[{bpp_loss / bpp_real * 100:5.1f}% of real]')
                    if flags.save_ours and ckpt_itr == last_itr:
                        save_img(img_name, otp['img_out'], val_dirs)
                    agg.update(otp)
                    print(f'{img_counter: 10d} {img_name} | '
                          f'Mean: {agg.averages_str()}', flush=True)
                    img_counter += 1
        finally:
            measures_writer.close()
        avgs = agg.averages()
        # Distance to BPG at the mean operating point (ref: val.py:198-206).
        try:
            d_ms = cd.CodecDistance(images_iterator.dataset_name, 'bpg',
                                    'ms-ssim').distance(avgs['bpp'], avgs['ms-ssim'])
            d_psnr = cd.CodecDistance(images_iterator.dataset_name, 'bpg',
                                      'psnr').distance(avgs['bpp'], avgs['psnr'])
            print(f'Distance to BPG: {d_ms:.3f} ms-ssim // {d_psnr:.3f} psnr')
            avgs['distance_BPG_MS-SSIM'] = d_ms
            avgs['distance_BPG_PSNR'] = d_psnr
        except (cd.CodecDistanceReadException, ValueError) as e:
            print(f'*** Distance to BPG not available: {e}')
        with open(path.join(val_dirs.out_dir, f'summary_{ckpt_itr}.json'), 'w') as f:
            json.dump({'iteration': ckpt_itr, **avgs}, f, indent=1)
        val_dirs.add_validated_checkpoint(ckpt_itr)
    print(f'Validation completed {val_dirs}')


def save_img(img_name: str, img_out_hwc: np.ndarray, val_dirs: ValidationDirs) -> None:
    from PIL import Image
    img_dir = path.join(val_dirs.out_dir, 'imgs')
    makedirs(img_dir, exist_ok=True)
    arr = np.asarray(img_out_hwc)
    if arr.ndim == 4:
        arr = arr[0]
    Image.fromarray(arr).save(path.join(img_dir, img_name))
