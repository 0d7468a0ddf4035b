"""Validation bookkeeping: the validated-checkpoints manifest and
measures.csv (own copy of imgcomp_cvpr_tpu/eval/val_files.py; ref:
val_files.py:13-101). The directory layout and file formats are the JAX
package's: ``<log root>/<log date> <dataset>/measures.csv`` with the header
``img_name,bpp,ms-ssim,psnr``, and ``validated_ckpts.json``.
"""

from __future__ import annotations

import json
import shutil
from os import path, makedirs
from typing import Iterator, List, Tuple

from ..utils import logdir as logdir_lib

MEASURES_FILE_NAME = 'measures.csv'


class ValidationDirs:
    """Out dir '{log_date} {dataset_name}' under the log root; tracks which
    ckpt iterations were validated (validated_ckpts.json)."""

    def __init__(self, ckpt_dir: str, log_dir_root: str, dataset_name: str,
                 reset: bool = False):
        self.ckpt_dir = ckpt_dir
        self.log_dir = logdir_lib.log_dir_from_ckpt_dir(ckpt_dir)
        self.log_dir_root = log_dir_root
        self.dataset_name = dataset_name
        log_date = logdir_lib.log_date_from_log_dir(self.log_dir)
        self.out_dir = path.join(log_dir_root, f'{log_date} {dataset_name}')
        self.validated_ckpts_f = path.join(self.out_dir, 'validated_ckpts.json')
        if reset and path.isdir(self.out_dir):
            print(f'*** rm -rf {self.out_dir}')
            shutil.rmtree(self.out_dir)
        makedirs(self.out_dir, exist_ok=True)

    @staticmethod
    def job_id_from_out_dir(out_dir: str) -> str:
        return logdir_lib.log_date_from_log_dir(path.basename(out_dir))

    def get_validated_checkpoints(self) -> List[int]:
        if not path.exists(self.validated_ckpts_f):
            return []
        with open(self.validated_ckpts_f) as f:
            return json.load(f)

    def add_validated_checkpoint(self, ckpt_itr: int) -> None:
        v = self.get_validated_checkpoints()
        v.append(ckpt_itr)
        with open(self.validated_ckpts_f, 'w') as f:
            json.dump(v, f)

    def __str__(self) -> str:
        return (f'Validation out dir: {self.out_dir}, validated: '
                f'{" ".join(map(str, self.get_validated_checkpoints()))}')


class MeasuresWriter:
    def __init__(self, out_dir: str):
        self.fout = open(path.join(out_dir, MEASURES_FILE_NAME), 'w')
        self.fout.write('img_name,bpp,ms-ssim,psnr\n')

    def append(self, img_name: str, otp: dict) -> None:
        self.fout.write(f"{img_name},{otp['bpp']},{otp['ms-ssim']},{otp['psnr']}\n")

    def close(self) -> None:
        self.fout.close()


class MeasuresReader:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.p = path.join(out_dir, MEASURES_FILE_NAME)
        if not path.isfile(self.p):
            raise FileNotFoundError(f'No {MEASURES_FILE_NAME} for {out_dir}')

    def iter_metric(self, metric: str) -> Iterator[Tuple[str, float, float]]:
        if metric not in ('ms-ssim', 'psnr'):
            raise ValueError(f'unknown metric {metric!r}')
        with open(self.p) as f:
            it = iter(f)
            next(it)
            for line in it:
                img_name, bpp, ms_ssim, psnr = line.strip().split(',')
                value = {'ms-ssim': ms_ssim, 'psnr': psnr}[metric]
                yield img_name, float(bpp), float(value)

    def get_job_id(self) -> str:
        return ValidationDirs.job_id_from_out_dir(self.out_dir)
