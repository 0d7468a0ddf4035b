"""Gap between an operating point and a baseline codec's R-D curve (own copy
of imgcomp_cvpr_tpu/eval/codec_distance.py).

Gives the d_BPG monitor (how far above or below BPG's MS-SSIM the model sits
at its current bpp) and the grid-averaged curves the plots use. The bpp grid,
the >= 99% coverage rule and the measures directory names are those of the
reference's analysis tooling (ref: codec_distance.py:19,25-42,70-100).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from ..utils import constants
from ..utils import logdir as logdir_lib
from . import other_codecs, val_files

DEFAULT_BPP_GRID = np.linspace(0.1, 1.4, 50)
_MIN_COVERAGE = 0.99   # a grid bin counts only if ~all images reach it

# dataset -> codec -> measures dir under $OTHER_CODECS_ROOT
# (directory names are a parity surface, ref: codec_distance.py:25-42)
CODECS = {
    'testset': {'bpg': 'out_bpg_imagenet_256_train_val_128x128__100',
                'jp': 'out_jp_imagenet_256_train_val_128x128__100'},
    'kodak': {'bpg': 'out_bpg_kodak_v2',
              'jp2k': 'out_jp2k_Kodak',
              'jp': 'out_jp_Kodak',
              'webp': 'out_webp_kodak'},
    # Kodak-geometry natural-statistics set (data/natural.py, indices
    # 10000-10023 at 512x768; the PNGs are in work_rd/natkodak24).
    'natkodak24': {'jp2k': 'out_jp2k_natkodak24',
                   'jp': 'out_jp_natkodak24',
                   'webp': 'out_webp_natkodak24'},
}


class CodecDistanceReadException(Exception):
    pass


def _grid_average(curves: Sequence[Tuple[np.ndarray, np.ndarray]],
                  grid: np.ndarray,
                  interp_mode: str) -> Tuple[List[float], List[float]]:
    """Average per-image R-D curves over a bpp grid. Each curve contributes
    to the bins inside its own bpp range; bins reached by < _MIN_COVERAGE of
    the curves are dropped (so the tails don't skew the average)."""
    if not curves:
        raise ValueError('no curves')
    acc = np.zeros(len(grid))
    hit = np.zeros(len(grid), np.int64)
    for bpps, values in curves:
        if len(bpps) < 2:
            raise ValueError('curve with < 2 points')
        inside = (grid >= bpps.min()) & (grid <= bpps.max())
        acc[inside] += _interp(grid[inside], bpps, values, interp_mode)
        hit[inside] += 1
    keep = hit > _MIN_COVERAGE * len(curves)
    if not keep.any():
        raise ValueError('No bins sufficiently covered')
    return list(grid[keep]), list(acc[keep] / hit[keep])


def _interp(x, xs, ys, mode):
    if mode == 'linear':
        return np.interp(x, xs, ys)
    import scipy.interpolate
    return scipy.interpolate.interp1d(xs, ys, mode)(x)


def _sorted_curve(pairs) -> Tuple[np.ndarray, np.ndarray]:
    arr = np.asarray(sorted(pairs))
    return arr[:, 0], arr[:, 1]


def codec_curve(codec_dir: str, grid: np.ndarray, metric: str,
                interp_mode: str = 'linear'):
    """Grid-averaged (bpp, metric) curve of a baseline codec from its
    per-image measure files."""
    files = other_codecs.all_measures_file_ps(codec_dir)
    if not files:
        raise CodecDistanceReadException(f'No matches in {codec_dir}')
    curves = [_sorted_curve(other_codecs.read_measures(p, metric))
              for p in files]
    return _grid_average(curves, grid, interp_mode)



class CodecDistance:
    """Signed metric gap to a baseline codec at a given bpp (> 0 means the
    queried point beats the codec)."""

    def __init__(self, dataset: str, codec: str, metric: str):
        if metric not in other_codecs.SUPPORTED_METRICS:
            raise ValueError(f'unknown metric {metric!r}')
        try:
            codec_dir = os.path.join(constants.OTHER_CODECS_ROOT,
                                     CODECS[dataset][codec])
        except KeyError:
            raise CodecDistanceReadException(
                f'No measures for codec={codec} on dataset={dataset}')
        try:
            grid, values = codec_curve(codec_dir, DEFAULT_BPP_GRID, metric)
        except (ValueError, CodecDistanceReadException) as e:
            raise CodecDistanceReadException(f'Failed: {e}')
        self._grid = np.asarray(grid)
        self._values = np.asarray(values)

    def distance(self, bpp: float, value: float) -> float:
        if not (self._grid[0] <= bpp <= self._grid[-1]):
            raise ValueError(f'bpp {bpp} outside codec curve '
                             f'[{self._grid[0]}, {self._grid[-1]}]')
        return float(value - np.interp(bpp, self._grid, self._values))


def get_measures_readers(log_dir_root: str, job_ids: str,
                         dataset: str) -> List[val_files.MeasuresReader]:
    """One MeasuresReader per validated job id; reports ids whose runs have
    no measures for the dataset. (The reference zipped job ids against a
    filtered dir iterator, misreporting which ids were missing when any run
    was absent from the log root — resolved per-id here.)"""
    readers: Dict[str, val_files.MeasuresReader] = {}
    missing = []
    for job_id in job_ids.strip().replace(';', ',').split(','):
        ckpt_dirs = list(logdir_lib.iter_ckpt_dirs(log_dir_root, job_id))
        if not ckpt_dirs:
            missing.append(job_id)
            continue
        for ckpt_dir in ckpt_dirs:
            vd = val_files.ValidationDirs(ckpt_dir, log_dir_root, dataset)
            try:
                readers[vd.out_dir] = val_files.MeasuresReader(vd.out_dir)
            except FileNotFoundError:
                missing.append(job_id)
    if missing:
        print('Missing measures files for:\n{}'.format(','.join(missing)))
    return list(readers.values())


def interpolate_ours(measures_readers, grid, interp_mode: str, metric: str):
    """Grid-averaged curve across runs: each image contributes one curve
    made of its (bpp, metric) points across the given runs."""
    per_image: Dict[str, list] = {}
    for mr in measures_readers:
        for img_name, bpp, value in mr.iter_metric(metric):
            per_image.setdefault(img_name, []).append((bpp, value))
    for img_name, pts in per_image.items():
        if len(pts) != len(measures_readers):
            raise ValueError(f'{img_name}: {len(pts)} points for '
                             f'{len(measures_readers)} runs')
    curves = [_sorted_curve(pts) for pts in per_image.values()]
    return _grid_average(curves, grid, interp_mode)
