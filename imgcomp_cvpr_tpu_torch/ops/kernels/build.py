"""Build and bind the port's hand-written CUDA kernels (nvcc + ctypes).

Every source in ``imgcomp_cvpr_tpu_torch/csrc/*.cu`` has a plain C
interface and is compiled on first use, for ``sm_90a`` (Hopper), into
``build/torch_kernels/lib<name>-<hash>.so`` at the repository root (the
hash of the source and of the shared headers ``csrc/*.cuh`` keys the file,
so an edited source or header is rebuilt). All
sources are compiled in parallel, one ``nvcc`` process each, the first time
any kernel is asked for. Nothing is compiled when this module is imported:
the CPU tests import it and never build. ``entry`` binds a C entry: its
argument types are set once, its return type is ``int`` (a cudaError_t, or
a count), and each wrapper keeps its own argument table.

Launch counters: each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else (``reset_launches`` zeroes them), so a
run can show that the main path went through the kernels. ``bias_rows``
counts the launches of the planar codec's bias-row kernel
(``csrc/bias_rows.cu``, ``coding/bias_rows.py``): 4 + C a round trip of C
planes on the card, 0 for K = 3. ``ae_epilogue`` counts the autoencoder's fused eval-mode conv epilogue
(``csrc/ae_epilogue.cu``, ``ops/kernels/ae_epilogue.py``): one a convolution
on the card, 70 a round trip of the CVPR towers (35 encode, 35 decode), 0
in training. ``wavefront_wdev`` counts the calls of kernel 2's wrapper
(``coding/cuda_kernel.wavefront_forward``) whose instance reads the weights
from device memory (``weights_in_device``: kf = 64 at L = 6, or ``force``),
beside their own counter: 0 at kf = 24, every kernel-2 call at kf = 64.
``plane_ring`` counts the calls of kernel 5's scan wrapper
(``coding/planar_kernel.plane_forward``) that ran its ring path
(``ring_fits``), beside their own counter: one a plane of a K = 5 kf = 24
decode at the Kodak latent, 0 for K = 3.

``train_graph_capture`` and ``train_graph_replay`` count the training
step's CUDA graph (``training/trainer.py``): a capture, and a replay (one
a step from the second call of a trainer on a card without a mesh; the
capturing call replays too). Kernels 1 and 7 inside the graph run without
their wrappers' Python; the trainer takes back what the wrappers counted
while the step was captured and adds it at each replay, so ``quantize``
and ``quantize_bwd`` count one each a training step, eager or replayed.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'torch_kernels')
SOURCES = ('quantize', 'quantize_bwd', 'wavefront_forward', 'rans_reverse',
           'plane_forward', 'ae_epilogue', 'bias_rows')
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
    'bias_rows': 0,
    'ae_epilogue': 0,
    'wavefront_wdev': 0,
    'plane_ring': 0,
    'train_graph_capture': 0,
    'train_graph_replay': 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], Tuple[ctypes._CFuncPtr, tuple]] = {}
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


def entry(source: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of csrc/<source>.cu, bound on first use with
    ``argtypes`` and an ``int`` return, and cached per (source, symbol).
    Raises if the same symbol is asked for with other argument types."""
    argtypes = tuple(argtypes)
    bound = _entries.get((source, symbol))
    if bound is None:
        fn = getattr(load(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        bound = _entries.setdefault((source, symbol), (fn, argtypes))
    if bound[1] != argtypes:
        raise TypeError(f'{source}.{symbol} is bound with argument types {bound[1]}, '
                        f'asked for with {argtypes}')
    return bound[0]


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
