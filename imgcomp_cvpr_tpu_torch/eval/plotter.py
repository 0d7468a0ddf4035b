"""Rate-distortion plots: runs of ours against baseline codecs and
published curves (own copy of imgcomp_cvpr_tpu/eval/plotter.py; ref:
plotter.py:111-236). Embeds the paper's Fig. 1 Kodak curve (ref
README.md:84-113) and the transcribed Rippel & Bourdev curve (ref
plotter.py:73-89).

    python -m imgcomp_cvpr_tpu_torch.eval.plotter LOG_ROOT JOB_IDS kodak -o rd.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils import constants
from . import codec_distance
from .codec_distance import CODECS, DEFAULT_BPP_GRID

LABEL_OURS = 'Ours'
LABEL_RB = 'Rippel & Bourdev'
LABEL_BPG = 'BPG'
LABEL_JP2K = 'JPEG2000'
LABEL_JP = 'JPEG'
LABEL_WEBP = 'WebP'

TITLES = {'kodak': 'Kodak', 'testset': 'TestSet'}

_CODEC_LABELS = {'bpg': LABEL_BPG, 'jp2k': LABEL_JP2K, 'jp': LABEL_JP,
                 'webp': LABEL_WEBP}

# Published Fig. 1 curve of the paper on Kodak (bpp, MS-SSIM)
# (ref: README.md:84-113, plotter.py:41-69).
CVPR_FIG1 = [
    (0.1265306, 0.9289356), (0.1530612, 0.9417454), (0.1795918, 0.9497924),
    (0.2061224, 0.9553684), (0.2326531, 0.9598574), (0.2591837, 0.9636625),
    (0.2857143, 0.9668663), (0.3122449, 0.9695684), (0.3387755, 0.9718446),
    (0.3653061, 0.9738012), (0.3918367, 0.9755308), (0.4183673, 0.9770696),
    (0.4448980, 0.9784622), (0.4714286, 0.9797252), (0.4979592, 0.9808753),
    (0.5244898, 0.9819255), (0.5510204, 0.9828875), (0.5775510, 0.9837722),
    (0.6040816, 0.9845877), (0.6306122, 0.9853407), (0.6571429, 0.9860362),
    (0.6836735, 0.9866768), (0.7102041, 0.9872690), (0.7367347, 0.9878184),
    (0.7632653, 0.9883268), (0.7897959, 0.9887977), (0.8163265, 0.9892346),
    (0.8428571, 0.9896379),
]

# Rippel & Bourdev 2017 Kodak curve, transcribed from their paper
# (ref: plotter.py:73-89).
RIPPEL_KODAK = [
    (.095, .92), (.14, .94), (.2, .956), (.3, .97), (.4, .9783), (.5, .983),
    (.6, .9858), (.7, .9880), (.8, .9897), (.9, .9914), (1.0, .9923),
    (1.1, .9935), (1.2, .994), (1.3, .9946), (1.4, .9954),
]


def interpolated_curve(log_dir_root: str, job_ids: str, dataset: str,
                       grid=DEFAULT_BPP_GRID, interp_mode: str = 'quadratic',
                       plot_interp_of_ours: bool = True,
                       plot_mean_of_ours: bool = False,
                       metric: str = 'ms-ssim',
                       x_range=(0, 1.2), y_range=(0.85, 1.0),
                       output_path: str = None,
                       paper_plot: bool = False) -> str:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    if not output_path:
        output_path = f'plot_{TITLES.get(dataset, dataset)}.png'

    plt.figure(figsize=(6, 6))
    cmap = plt.get_cmap('cool')
    codec_colors = {LABEL_BPG: cmap(0.7), LABEL_JP2K: cmap(0.45),
                    LABEL_JP: cmap(0.2), LABEL_WEBP: cmap(0.1)}

    for codec_short, measures_dir in CODECS.get(dataset, {}).items():
        measures_dir = os.path.join(constants.OTHER_CODECS_ROOT, measures_dir)
        if not os.path.exists(measures_dir):
            continue
        label = _CODEC_LABELS[codec_short]
        try:
            g, v = codec_distance.codec_curve(measures_dir, grid, metric)
        except codec_distance.CodecDistanceReadException:
            continue
        plt.plot(g, v, label=label, linewidth=1.5, color=codec_colors[label])

    if dataset == 'kodak':
        plt.plot(*zip(*RIPPEL_KODAK), label=LABEL_RB, color=cmap(0.9),
                 linewidth=1.5)

    if job_ids:
        for group in job_ids.split(';'):
            readers = codec_distance.get_measures_readers(log_dir_root, group,
                                                          dataset)
            if not readers:
                continue
            if plot_interp_of_ours:
                try:
                    g, v = codec_distance.interpolate_ours(readers, grid,
                                                           interp_mode, metric)
                    plt.plot(g, v, label=LABEL_OURS, color='0', linewidth=3)
                except ValueError as e:
                    print(f'Cannot interpolate: {e}')
                    plot_mean_of_ours = True
            if plot_mean_of_ours:
                for first, mr in [(i == 0, m) for i, m in enumerate(readers)]:
                    bpps, vals = [], []
                    for _, bpp, value in mr.iter_metric(metric):
                        bpps.append(bpp)
                        vals.append(value)
                    plt.scatter(np.mean(bpps), np.mean(vals), marker='x',
                                zorder=10, color='0',
                                label=LABEL_OURS if first else None)

    if paper_plot:
        plt.plot(*zip(*CVPR_FIG1), label='Fig. 1', color='0', linewidth=3,
                 dashes=(5, 1))

    plt.title(f'{metric.upper()} on {TITLES.get(dataset, dataset)}')
    plt.xlabel('bpp', labelpad=-5)
    plt.grid(True, color='0.8')
    plt.legend(loc=4, prop={'size': 12}, fancybox=True, framealpha=0.7)
    plt.xlim(x_range)
    plt.ylim(y_range)
    print(f'Saving {output_path}...')
    plt.savefig(output_path, bbox_inches='tight')
    plt.close()
    return output_path


def main():
    p = argparse.ArgumentParser()
    p.add_argument('log_dir_root')
    p.add_argument('job_ids', help='Comma-separated; ";" separates groups.')
    p.add_argument('images', help='dataset name, e.g. kodak')
    p.add_argument('--x_range', default='0,1.2')
    p.add_argument('--y_range', default='0.85,1.0')
    p.add_argument('--output_path', '-o')
    p.add_argument('--style', nargs='+', default=['interp'],
                   choices=['interp', 'mean'])
    p.add_argument('--paper_plot', action='store_true')
    flags = p.parse_args()

    rng = lambda r: tuple(map(float, r.split(',')))
    interpolated_curve(flags.log_dir_root, flags.job_ids, flags.images,
                       plot_interp_of_ours='interp' in flags.style,
                       plot_mean_of_ours='mean' in flags.style,
                       x_range=rng(flags.x_range), y_range=rng(flags.y_range),
                       output_path=flags.output_path,
                       paper_plot=flags.paper_plot)


if __name__ == '__main__':
    main()
