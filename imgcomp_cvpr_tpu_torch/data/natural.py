"""Deterministic 1/f^2 ('pink spectrum') natural-statistics images. Own copy
of imgcomp_cvpr_tpu/data/natural.py: the same bytes for the same arguments.

Real photographs have an ~1/f^2 power spectrum; procedural images with that
spectrum exercise a learned image codec far more honestly than the
sinusoid-grid ``synthetic`` source. Every image is a pure function of its
index and size, so a dataset needs no files and regenerates bit-identically
anywhere: ``natural[:N[:HxW]]`` in data/pipeline.py, and the 24 PNGs of
``work_rd/natkodak24`` (indices 10000-10023 at 512x768).

An image is built from four independent pink-noise fields: a shared
luminance field plus small per-channel deviations.
"""

from __future__ import annotations

import numpy as np


def pink_field(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """One 1/f-amplitude (=> 1/f^2 power) noise field, min-max mapped to
    [0, 1]. (h, w) float32."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    spec = (1.0 / f) * np.exp(2j * np.pi * rng.rand(h, w))
    x = np.real(np.fft.ifft2(spec)).astype(np.float32)
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo + 1e-9)


def natural_image(idx: int, h: int = 512, w: int = 768) -> np.ndarray:
    """Deterministic HWC uint8 RGB image #idx (0.8 shared luminance +
    0.2 per-channel pink deviations)."""
    # fold the shape into the seed so differently-sized sets are
    # independent; keep within the 32-bit RandomState seed range
    rng = np.random.RandomState((idx * 2654435761 + h * 40503 + w) % (2**31))
    base = pink_field(rng, h, w)
    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        out[:, :, c] = np.clip(0.8 * base + 0.2 * pink_field(rng, h, w),
                               0.0, 1.0) * 255.0
    return np.round(out).astype(np.uint8)
