"""Build and bind the port's hand-written CUDA kernels (nvcc + ctypes).

Every source in ``imgcomp_cvpr_tpu_torch/csrc/*.cu`` has a plain C
interface and is compiled on first use, for ``sm_90a`` (Hopper), into
``build/torch_kernels/lib<name>-<hash>.so`` at the repository root (the
hash of the source and of the shared headers ``csrc/*.cuh`` keys the file,
so an edited source or header is rebuilt). All
sources are compiled in parallel, one ``nvcc`` process each, the first time
any kernel is asked for. Nothing is compiled when this module is imported:
the CPU tests import it and never build.

Launch counters: each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else (``reset_launches`` zeroes them), so a
run can show that the main path went through the kernels. One counter is
not a kernel wrapper: ``bias_row_conv`` counts the planar codec's bias-row
``F.conv2d`` calls (cuDNN's, 8 B C a batch encoded and decoded).
``ae_epilogue`` counts the autoencoder's fused eval-mode conv epilogue
(``csrc/ae_epilogue.cu``, ``ops/kernels/ae_epilogue.py``): one a convolution
on the card, 70 a round trip of the CVPR towers (35 encode, 35 decode), 0
in training. ``wavefront_wdev`` counts the calls of kernel 2's wrapper
(``coding/cuda_kernel.wavefront_forward``) whose instance reads the weights
from device memory (``weights_in_device``: kf = 64 at L = 6, or ``force``),
beside their own counter: 0 at kf = 24, every kernel-2 call at kf = 64.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'torch_kernels')
SOURCES = ('quantize', 'quantize_bwd', 'wavefront_forward', 'rans_reverse',
           'plane_forward', 'ae_epilogue')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

LAUNCHES: Dict[str, int] = {
    'quantize': 0,
    'quantize_bwd': 0,
    'wavefront_forward_encode': 0,
    'wavefront_forward_encode_scan': 0,
    'wavefront_forward_decode': 0,
    # kernel 2 at precisions 1 and 2 (cuda_kernel.launch_name)
    'wavefront_forward_encode_bf16': 0,
    'wavefront_forward_encode_scan_bf16': 0,
    'wavefront_forward_decode_bf16': 0,
    'wavefront_forward_encode_f8': 0,
    'wavefront_forward_encode_scan_f8': 0,
    'wavefront_forward_decode_f8': 0,
    'rans_reverse': 0,
    'plane_forward_encode': 0,
    'plane_forward_encode_scan': 0,
    'plane_forward_decode': 0,
    'plane_reverse': 0,
    'bias_row_conv': 0,
    'ae_epilogue': 0,
    'wavefront_wdev': 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built on the '
                       'machine with the card (CUDA toolkit required)')


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for src in [name + '.cu'] + sorted(f for f in os.listdir(CSRC) if f.endswith('.cuh')):
        with open(os.path.join(CSRC, src), 'rb') as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f'lib{name}-{digest}.so')


def build_all() -> Dict[str, str]:
    """Compile every missing kernel library in parallel; returns
    {name: ptxas log}. Raises with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f'{out}.{os.getpid()}.tmp'
        procs[name] = (subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ['-o', tmp, os.path.join(CSRC, name + '.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f'--- {name}.cu (exit {proc.returncode}) ---\n{log}')
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """ctypes handle of csrc/<name>.cu's library, building all on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with cudaError {err}')


def on_device(device: torch.device):
    """torch.cuda.device(device), or nothing where it is current already."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
