"""The benchmark's shared machinery: it finds a cell's files by the names in
BENCHMARK.json, builds the program under test from a configuration file,
loads the image set, records spans, and assembles the result line.

A cell is (configuration, traffic). ``configs/<config>.json`` states the
model and its precisions; ``traffic/<traffic>.json`` is a data file whose
``runner`` key names the general runner in ``runners/`` that reads it;
``limits/<workload>.json`` holds the limits of the numbers that decide
``correct``; ``metrics/<stem>.py`` is the reader of the per-layer metrics
named ``<stem>`` or ``<stem>.<cells>`` (``device_idle_pct.py`` reads
``device_idle_pct.stream`` and ``device_idle_pct.train``).
A new cell, mix or metric is new files and new BENCHMARK.json entries.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, NamedTuple, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, 'perfbench')
BENCHMARK = os.path.join(ROOT, 'BENCHMARK.json')
# The JAX side of the repository: nothing the benchmark runs may load it.
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'imgcomp_cvpr_tpu')


def process_env() -> Dict[str, str]:
    """The environment a run sets before it imports torch: build and kernel
    caches at fixed paths inside the checkout, so that only a cell's first
    run in a checkout builds (the program's own nvcc libraries already
    live in build/torch_kernels; PyTorch's jit-compiled elementwise
    kernels, such as MS-SSIM's powers, go to build/torch_kernel_cache);
    one host thread for OpenMP and MKL, so the host's side of each request
    does not wait on a pool's threads that share the machine's cores.
    PyTorch uses a kernel cache directory that it is given only where it
    exists already, so that one is made here."""
    kernel_cache = os.path.join(ROOT, 'build', 'torch_kernel_cache')
    os.makedirs(kernel_cache, exist_ok=True)
    return {'TORCH_EXTENSIONS_DIR': os.path.join(ROOT, 'build', 'torch_extensions'),
            'TRITON_CACHE_DIR': os.path.join(ROOT, 'build', 'triton'),
            'CUDA_CACHE_PATH': os.path.join(ROOT, 'build', 'nv_compute_cache'),
            'PYTORCH_KERNEL_CACHE_PATH': kernel_cache,
            'OMP_NUM_THREADS': '1', 'MKL_NUM_THREADS': '1'}


def load_json(rel: str) -> Dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def load_benchmark() -> Dict:
    with open(BENCHMARK) as f:
        return json.load(f)


def workload(bench: Dict, name: str) -> Dict:
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def config_entry(bench: Dict, name: str) -> Dict:
    for c in bench['configs']:
        if c['name'] == name:
            return c
    raise KeyError(f'no config {name!r} in BENCHMARK.json')


def metrics_of(bench: Dict, section: str, cell: str) -> List[Dict]:
    """The entries of ``section`` ('end_to_end' or 'per_layer') that the
    cell reports: those listing it, and those with no list."""
    return [m for m in bench[section] if cell in m.get('workloads', [cell])]


def load_module(path: str, name: Optional[str] = None):
    """A module of the benchmark by its file path (a metric's name holds
    dots, so its reader is loaded by path, not imported by name)."""
    spec = importlib.util.spec_from_file_location(name or 'pb_' + os.path.basename(path), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(name: str):
    return load_module(os.path.join(HERE, 'runners', name + '.py'), 'pb_runner_' + name)


def reader(metric: str):
    """The reader of per-layer metric ``metric``: ``metrics/<stem>.py``,
    the stem being the name up to its first dot."""
    stem = metric.split('.', 1)[0]
    return load_module(os.path.join(HERE, 'metrics', stem + '.py'), 'pb_metric_' + stem)


def sha256_files(paths: List[str]) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()


def forbidden_loaded() -> List[str]:
    """Top-level names of sys.modules that belong to the JAX side, compared
    whole: imgcomp_cvpr_tpu_torch is the port, imgcomp_cvpr_tpu is not."""
    tops = {m.split('.', 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

SPAN_PREFIX = 'pb.'
_NULL = contextlib.nullcontext()


class Tracer:
    """Named spans around the calls the harness makes into the program,
    recorded by torch.profiler as user annotations in a traced run and free
    otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return _NULL
        import torch
        return torch.profiler.record_function(SPAN_PREFIX + name)

    def start(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()

    def stop(self):
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def events(self):
        return self.prof.profiler.kineto_results.events()


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------

def load_images(spec: Dict, device):
    """The traffic's image set as one (N, H, W, 3) uint8 tensor on
    ``device``: the files that ``spec['glob']`` names under the checkout,
    sorted, held to ``spec['sha256']`` (their bytes in that order), so a
    change to the files cannot pass unseen."""
    import glob
    import numpy as np
    import torch
    from PIL import Image
    paths = sorted(glob.glob(os.path.join(ROOT, spec['glob'])))
    if len(paths) != spec['count']:
        raise RuntimeError(f'{spec["glob"]}: {len(paths)} files, expected {spec["count"]}')
    digest = sha256_files(paths)
    if digest != spec['sha256']:
        raise RuntimeError(f'{spec["glob"]}: sha256 {digest}, expected {spec["sha256"]}')
    arrs = []
    for p in paths:
        with Image.open(p) as im:
            arrs.append(np.asarray(im.convert('RGB'), np.uint8))
    return torch.from_numpy(np.stack(arrs)).to(device)


def check_file(rel: str, sha256: str) -> str:
    path = os.path.join(ROOT, rel)
    digest = sha256_files([path])
    if digest != sha256:
        raise RuntimeError(f'{rel}: sha256 {digest}, expected {sha256}')
    return path


# ---------------------------------------------------------------------------
# Result
# ---------------------------------------------------------------------------

class Window(NamedTuple):
    """What a runner's window hands back: its host clock at the start and
    the end, its counts (``units``, ``attempted``, ``failed`` and the
    runner's own), its end-to-end metrics, the samples the check compares
    and numbers printed beside them."""
    t0: float
    t1: float
    counts: Dict
    e2e: Dict
    samples: List
    extra: Dict


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """-> (correct, [(name, value, limit)]): correct when every number
    compared is at most its limit (a NaN is not)."""
    checks = [(name, values[name], limits[name]) for name in limits]
    return all(v <= lim for _, v, lim in checks), checks


def device_info(device, peaks: Optional[List[int]] = None) -> Dict:
    """The result's ``device``. ``peaks``, in a cell on several cards, holds
    every rank's memory peak: ``count`` is then the number of cards and
    ``memory_peak_bytes`` the fullest card's."""
    import torch
    count = len(peaks) if peaks else 1
    if device.type == 'cuda':
        peak = max(peaks) if peaks else int(torch.cuda.max_memory_allocated(device))
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
                'count': count, 'memory_peak_bytes': peak}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': count, 'memory_peak_bytes': 0}


def power_limit() -> str:
    """Each card's name and power limit as nvidia-smi reads them, or why not."""
    import subprocess
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=20)
        cards = out.stdout.strip().splitlines()
        return '; '.join(cards) if out.returncode == 0 and cards else 'not read'
    except (OSError, subprocess.SubprocessError):
        return 'not read'
