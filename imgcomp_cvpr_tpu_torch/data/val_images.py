"""Resolve a validation-image spec into file paths (own copy of
imgcomp_cvpr_tpu/data/val_images.py; ref: val_images.py:12-24).

A spec is a registered dataset alias (under $VAL_ROOT), a directory of PNGs,
or a glob. The short name keys validation output directories and the
baseline codecs' measure tables, so it is the JAX package's letter for
letter.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import List, Tuple

from ..utils import constants

_ALIASES = {
    'kodak': ('kodak', '*.png'),
    'testset': ('imagenet_256_train_val_128x128__100', '*.png'),
}


def dataset_glob(alias: str) -> str:
    sub, pattern = _ALIASES[alias]
    return os.path.join(constants.VALIDATION_DATASETS_ROOT, sub, pattern)


def get_image_paths(spec: str) -> Tuple[List[str], str]:
    """spec -> (sorted image paths, dataset short name)."""
    if spec in _ALIASES:
        pattern, name = dataset_glob(spec), spec
    elif any(ch in spec for ch in '*?['):
        pattern, name = spec, _name_from_pattern(spec)
    else:  # a plain directory
        pattern = os.path.join(spec, '*.png')
        name = os.path.basename(os.path.normpath(spec))
    paths = sorted(globlib.glob(pattern))
    if not paths:
        raise ValueError(f'Not matching any files: {pattern}')
    return paths, name


def _name_from_pattern(pattern: str) -> str:
    """Deepest literal path component of a glob, used as the dataset name."""
    parts = os.path.normpath(pattern).split(os.sep)
    for comp in reversed(parts):
        if comp and not any(ch in comp for ch in '*?['):
            return comp
    raise ValueError(f'No literal path component in: {pattern}')
