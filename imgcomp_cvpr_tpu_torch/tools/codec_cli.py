"""Standalone image <-> compressed-file codec CLI (port of
imgcomp_cvpr_tpu/tools/codec_cli.py; runs on one CUDA card unless --device
says otherwise).

`compress` runs the AE encode and the entropy coder (kernels 1, 2 and 3
for a kernel_size 3 context model, kernels 1, 5 and 6 for any other) and
writes a self-describing `.icz` file; `decompress` restores the PNG;
`roundtrip` does both and prints bytes, bpp and PSNR. Integrity is
double-checked: the entropy container's symbol CRC (decode fails loudly on
corruption or a model mismatch) plus a model tag in the header (CRC of the
center values) so a wrong checkpoint is rejected before a confusing
mis-decode. The container carries the port's impl id (5 or 6): a file
written by the JAX package's tool (ids 0-4) is refused, since logits of
another implementation give other CDFs. The K=3 codec compresses at the
operand precision that $IMGCOMP_PALLAS_PREC names (f32, bf16 or f8; f32
when unset), as the JAX tool does; decompress reads it from the container.

File format (little-endian), the JAX tool's:
    magic b'ICZ1' | u16 orig_h | u16 orig_w | u32 model_tag
    | u32 n_bytes | <entropy container bytes (coding/codec.py)>

The AE runs under cuDNN's deterministic algorithms (the decoder's
transposed convolutions otherwise sum in an order that changes from run to
run), so a file decompresses to the same pixels every time.

Model loading: --log_dir (configs recovered from the log-dir name + the
latest, or --itr, checkpoint that train_torch.py wrote) or --npz (a flat
params/batch_stats tree like assets/demo_trained_low_9000.npz) with
--ae_config/--pc_config specs.

Usage:
    python -m imgcomp_cvpr_tpu_torch.tools.codec_cli compress kodim01.png \
        -o kodim01.icz --npz assets/demo_trained_low_9000.npz
    python -m imgcomp_cvpr_tpu_torch.tools.codec_cli decompress kodim01.icz \
        -o kodim01_out.png --npz assets/demo_trained_low_9000.npz
"""

from __future__ import annotations

import argparse
import struct
import sys
import zlib
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..eval.validate import deterministic_cudnn

_MAGIC = b'ICZ1'
_PAD = 8   # AE subsampling factor (ref autoencoder.py:214-216)


class CodecModel:
    """An (ae, pc) pair of the port's modules (on one device, eval mode)
    with the encode / decode halves and the entropy codec; shared by
    compress and decompress."""

    def __init__(self, ae, pc):
        from ..coding import codec as codec_lib
        self.ae, self.pc = ae, pc
        self.ae_config = ae.config
        self.device = ae.encoder.centers.device
        self.codec = codec_lib.LatentCodec(pc, pc.config, device=self.device)
        centers = ae.encoder.centers.detach()
        self._centers_dev = centers.to(torch.float32)
        # a host array keeps the codec's submits free of waits for the card
        self.centers = centers.cpu().numpy().astype(np.float32)

    def _enc(self, x_uint8: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 padded images -> (B, C, H', W') int8 symbols
        on the model's device."""
        x = torch.from_numpy(np.require(x_uint8, np.uint8, ['C', 'W'])).to(
            self.device, torch.float32)
        with deterministic_cudnn():
            out = self.ae.encode(x)
        return out.symbols.permute(0, 3, 1, 2).to(torch.int8).contiguous()

    def _dec(self, syms_chw: torch.Tensor) -> torch.Tensor:
        """(B, C, H', W') symbols -> (B, H, W, 3) uint8 images on the
        model's device."""
        q = self._centers_dev[syms_chw.permute(0, 2, 3, 1).long()]
        with deterministic_cudnn():
            x = self.ae.decode(q)
        return x.clamp(0, 255).to(torch.uint8)

    @property
    def model_tag(self) -> int:
        """Cheap model-identity check: CRC32 of the center values. Wrong
        checkpoints with identical centers still fail the container's
        symbol CRC at decode."""
        return zlib.crc32(self.centers.tobytes()) & 0xFFFFFFFF

    def compress(self, img_hwc: np.ndarray) -> bytes:
        from ..data.images_iterator import add_padding
        oh, ow = img_hwc.shape[:2]
        if not (oh < 65536 and ow < 65536):
            raise ValueError(f'image {oh}x{ow} too large for the u16 header')
        padded, _ = add_padding(np.asarray(img_hwc, np.uint8), _PAD)
        syms = self._enc(padded[None])
        (res,) = self.codec.encode_batch(syms, self.centers)
        bs = res.bitstream
        return (_MAGIC + struct.pack('<HHII', oh, ow, self.model_tag,
                                     len(bs)) + bs)

    def decompress(self, blob: bytes) -> np.ndarray:
        if blob[:4] != _MAGIC:
            raise ValueError('not an ICZ1 file')
        oh, ow, tag, n = struct.unpack('<HHII', blob[4:16])
        if tag != self.model_tag:
            raise ValueError(
                f'model tag mismatch: file 0x{tag:08x} vs loaded model '
                f'0x{self.model_tag:08x} — wrong checkpoint for this file')
        bs = blob[16:16 + n]
        if len(bs) != n:
            raise ValueError('truncated file')
        syms = self.codec.decode_batch([bs], self.centers, device_out=True)
        x = self._dec(syms)[0]
        hp = (_PAD - oh % _PAD) % _PAD
        wp = (_PAD - ow % _PAD) % _PAD
        hp_lo, wp_lo = hp // 2, wp // 2
        return x[hp_lo:hp_lo + oh, wp_lo:wp_lo + ow, :].cpu().numpy()


def load_model(log_dir: Optional[str] = None, npz: Optional[str] = None,
               ae_spec: str = 'cvpr/low', pc_spec: str = 'cvpr/res_shallow',
               itr: Optional[int] = None, device='cuda') -> CodecModel:
    from ..utils import config as config_lib
    dev = resolve_device(device)
    if log_dir:
        from os import path as osp
        from ..eval.validate import build_eval_model_from_log_dir
        from ..training import checkpoint as ckpt_lib
        em = build_eval_model_from_log_dir(log_dir, device=dev)
        raw, _ = ckpt_lib.Saver(osp.join(log_dir, 'ckpts')).restore(itr)
        em.set_params(raw['model'])
        return CodecModel(em.ae, em.pc)
    if not npz:
        raise ValueError('need --log_dir or --npz')
    from .. import weights as weights_lib
    from ..models import autoencoder as ae_lib
    from ..models import probclass as pc_lib
    ae_config, _ = config_lib.parse_spec(ae_spec, 'ae')
    pc_config, _ = config_lib.parse_spec(pc_spec, 'pc')
    ae = ae_lib.get_network_cls(ae_config)(ae_config, device=dev)
    pc = pc_lib.ProbClassifier(pc_config, ae_config.num_centers, device=dev)
    ae, pc = weights_lib.load_trained(npz, ae, pc, device=dev)
    return CodecModel(ae, pc)


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'), np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('mode', choices=['compress', 'decompress', 'roundtrip'])
    p.add_argument('input')
    p.add_argument('-o', '--output', required=True)
    p.add_argument('--log_dir', help='training log dir (configs + ckpts)')
    p.add_argument('--itr', type=int, help='checkpoint iteration (latest '
                   'if omitted)')
    p.add_argument('--npz', help='flat params/batch_stats npz asset')
    p.add_argument('--ae_config', default='cvpr/low')
    p.add_argument('--pc_config', default='cvpr/res_shallow')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises with no card) or 'cpu'.")
    a = p.parse_args(argv)
    model = load_model(log_dir=a.log_dir, npz=a.npz, ae_spec=a.ae_config,
                       pc_spec=a.pc_config, itr=a.itr, device=a.device)
    if a.mode == 'compress':
        img = _read_rgb(a.input)
        blob = model.compress(img)
        with open(a.output, 'wb') as f:
            f.write(blob)
        bpp = len(blob) * 8 / (img.shape[0] * img.shape[1])
        print(f'{a.input} -> {a.output}: {len(blob)} bytes, '
              f'{bpp:.4f} bpp (file, incl. header)')
    elif a.mode == 'roundtrip':
        # image -> .icz file -> image with metrics: the per-image self-check
        # the reference runs inside val.py --real_bpp (ref bit_counter.py:
        # 13-74), as a one-command user tool. Decode integrity is CRC-
        # gated; metrics quantify the lossy AE, not the (lossless) coder.
        from ..ops import metrics as metrics_lib
        img = _read_rgb(a.input)
        blob = model.compress(img)
        with open(a.output, 'wb') as f:
            f.write(blob)
        out = model.decompress(blob)
        bpp = len(blob) * 8 / (img.shape[0] * img.shape[1])
        psnr = metrics_lib.psnr_np(img, out)
        print(f'{a.input} -> {a.output} -> reconstructed: {len(blob)} bytes '
              f'({bpp:.4f} bpp), decode CRC-verified, PSNR {psnr:.2f} dB')
    else:
        from PIL import Image
        with open(a.input, 'rb') as f:
            blob = f.read()
        out = model.decompress(blob)
        Image.fromarray(out).save(a.output)
        print(f'{a.input} -> {a.output}: {out.shape[1]}x{out.shape[0]}')


if __name__ == '__main__':
    sys.exit(main())
