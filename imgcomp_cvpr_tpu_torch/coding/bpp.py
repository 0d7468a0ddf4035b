"""Real-vs-theoretical bpp pairing (port of imgcomp_cvpr_tpu/coding/bpp.py,
ref bpp_helpers.py:13-31).

Given a symbol volume, entropy-code it for real through the port's
LatentCodec (bit-exact round trip checked) and return (real bpp,
theoretical bpp). The context model is bound to the codec, so the fetcher
takes the codec and the centers only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import codec as codec_lib


def num_pixels_in_image(img_hwc: np.ndarray) -> int:
    return int(img_hwc.shape[0] * img_hwc.shape[1])


class BppFetcher:
    def __init__(self, codec: codec_lib.LatentCodec, centers):
        self.codec = codec
        self.centers = np.asarray(centers, np.float32)

    def get_bpp(self, symbols_chw: np.ndarray, num_pixels: int) -> Tuple[float, float]:
        """-> (bpp_real, bpp_theoretical); asserts a bit-exact round trip."""
        result = self.codec.roundtrip(symbols_chw, self.centers)
        return (result.num_bits / num_pixels,
                result.theoretical_bits / num_pixels)
