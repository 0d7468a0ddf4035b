#!/usr/bin/env python3
"""Run one benchmark cell once, on the NVIDIA cards it asks for, and print
its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, limits and per-layer readers are
found by the names in BENCHMARK.json (see harness.py). The program under
test is imgcomp_cvpr_tpu_torch; nothing here imports JAX or the JAX package.

A cell on one card runs in this process on cuda:0. A cell on N > 1 cards
runs as N ranks, one a card, started through the program's
parallel/mesh.py (ranks.py): every rank runs set-up and the window, rank 0
reads the clock, runs the reference and hands the result back to this
process, which prints it.

Set-up (weights, images, the program's kernels built or loaded, every shape
of the window warmed up) runs first; then the window runs for --seconds and
ends with a synchronize; then, with the program's state freed, the plain
reference judges a sample of what the window produced. With --trace 0 the
result carries the cell's end-to-end metrics, with --trace 1 its per-layer
metrics, read from a torch.profiler trace of the window.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last checks (each
number compared, with its limit). The checks are also the last lines of
standard error. Without a CUDA card, or with fewer cards than the cell asks
for, it prints no result and exits 2; if the JAX side was loaded, 3; if a
rank failed, 1; if the ranks did not finish in time, 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402

for _k, _v in harness.process_env().items():
    os.environ[_k] = _v


def _finite(v):
    return v if isinstance(v, int) or math.isfinite(v) else None


def run_cell(bench, name, seed, seconds, trace, device, t_start, overrides=None, group=None):
    """One run of cell ``name`` on ``device`` -> (result dict, stderr lines).
    ``overrides`` replaces keys of the traffic file (the CPU tests' sizes).
    ``group`` (ranks.Group) makes this one rank of a multi-card cell: the
    ranks other than 0 hand back (None, [])."""
    import torch
    from perfbench import trace as trace_lib
    cell = harness.workload(bench, name)
    cfg = harness.load_json(harness.config_entry(bench, cell['config'])['file'])
    cfg['name'] = cell['config']
    traffic = harness.load_json(os.path.join('perfbench', 'traffic', cell['traffic'] + '.json'))
    traffic.update(overrides or {})
    limits = harness.load_json(os.path.join('perfbench', 'limits', name + '.json'))
    drv = harness.runner(traffic['runner'])
    tracer = harness.Tracer(bool(trace))
    if device.type == 'cuda':
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    ctx = drv.setup(cfg, traffic, seed, device, tracer, **({'group': group} if group else {}))
    gc.collect()
    gc.freeze()     # set-up's objects out of the collector's way in the window
    from imgcomp_cvpr_tpu_torch.ops.kernels import build as kbuild
    kbuild.reset_launches()
    tracer.start()
    win = drv.window(ctx, seconds)
    tracer.stop()
    gc.unfreeze()
    launches = {k: v for k, v in kbuild.LAUNCHES.items() if v}
    summ = trace_lib.summarize(tracer.events(), win.counts, drv.work(ctx, win)) if trace else None
    peaks, busy, rank_lines = None, None, []
    if group is not None:
        mine = {'peak': int(torch.cuda.max_memory_allocated(device)) if device.type == 'cuda'
                else 0, 'busy_s': summ.busy_s if summ else None, 'extra': win.extra}
        infos = group.gather(mine)
        if not group.lead:
            tracer.prof = None
            drv.release(ctx)
            return None, []
        peaks = [i['peak'] for i in infos]
        busy = [i['busy_s'] for i in infos]
        rank_lines = [f'rank {r}: memory peak {i["peak"]} bytes, busy {i["busy_s"]} s, '
                      f'{json.dumps(i["extra"])}' for r, i in enumerate(infos)]
    dev = harness.device_info(device, peaks)
    lines = [f'device: {dev["kind"]}, {harness.power_limit() if device.type == "cuda" else "cpu"}',
             f'window: {win.t1 - win.t0:.6f} s, counts {json.dumps(win.counts)}',
             f'launches in the window: {json.dumps(launches)}; a unit: '
             f'{json.dumps({k: v / max(win.counts["units"], 1) for k, v in launches.items()})}']
    lines += [f'{k}: {v}' for k, v in win.e2e.items()]
    lines += [f'{k}: {v}' for k, v in win.extra.items()]
    lines += rank_lines
    result = {}
    if trace:
        metrics = {}
        for m in harness.metrics_of(bench, 'per_layer', name):
            v = harness.reader(m['name']).read(summ)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        # busy seconds averaged over the cards; the per-layer metrics read rank 0's
        dev['busy_s'] = sum(busy) / len(busy) if busy else summ.busy_s
        dev['window_s'] = summ.window_s
        result['breakdown'] = summ.breakdown()
        lines.append(f'work a unit (least s at the peaks in roofline/peaks.json): '
                     f'{json.dumps(summ.work)}')
        lines.append(f'traced: {len(summ.kernels)} kernels, {summ.device_s([None]):.6f} s '
                     f'of them outside every span; host s by span {json.dumps(summ.host_spans)}')
    else:
        # memory_peak_gb: the fullest card's peak, as the result's device reports it
        values = dict(win.e2e, setup_s=win.t0 - t_start,
                      memory_peak_gb=dev['memory_peak_bytes'] / 1e9)
        metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
                   for m in harness.metrics_of(bench, 'end_to_end', name)}
    tracer.prof = None
    drv.release(ctx)
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    timing = {}
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    t_ref = time.perf_counter()
    values = drv.numbers(ctx, win.samples, timing)
    ref_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == 'cuda' else 0
    lines.append(f'reference: {time.perf_counter() - t_ref:.3f} s, memory peak {ref_peak} '
                 f'bytes, by stage {json.dumps(timing)}')
    correct, checks = harness.judge(values, limits)
    lines += [f'{k}: {v!r}' for k, v in values.items() if k not in limits]
    correct = correct and win.counts['failed'] == 0
    out = {'correct': correct, 'attempted': win.counts['attempted'],
           'failed': win.counts['failed'], 'metrics': metrics, 'device': dev}
    out.update(result)
    out['checks'] = {n: {'value': _finite(v), 'limit': lim} for n, v, lim in checks}
    lines += [f'check {n}: {v!r} limit {lim!r}' for n, v, lim in checks]
    return out, lines


def run_ranks(bench, name, seed, seconds, trace, t_start, world, device_type,
              overrides=None, rank_fn=None, limit_s=None):
    """One run of a multi-card cell as ``world`` ranks (ranks.rank_run, or
    ``rank_fn`` with its arguments) -> rank 0's (result, stderr lines, the
    JAX side's modules that any rank loaded), or None when a rank failed. The ranks must finish
    within ``limit_s`` (default: the window and ranks.STALL_S)."""
    from perfbench import ranks
    return ranks.spawn(rank_fn or ranks.rank_run, world, device_type,
                       (bench, name, seed, seconds, trace, t_start, overrides),
                       seconds + ranks.STALL_S if limit_s is None else limit_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    bench = harness.load_benchmark()
    cell = harness.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        print(f'perfbench: the cell needs {cell["chips"]} CUDA card(s); '
              f'torch.cuda.is_available() is {torch.cuda.is_available()}, '
              f'device_count() {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    if cell['chips'] == 1:
        out, lines = run_cell(bench, args.workload, args.seed, args.seconds, args.trace,
                              torch.device('cuda', 0), T_START)
        found = harness.forbidden_loaded()
    else:
        res = run_ranks(bench, args.workload, args.seed, args.seconds, args.trace, T_START,
                        cell['chips'], 'cuda')
        if res is None:
            return 1
        out, lines, found = res
        found = sorted(set(found) | set(harness.forbidden_loaded()))
    if found:
        print(f'perfbench: the JAX side was loaded: {found}', file=sys.stderr)
        return 3
    sys.stderr.write('\n'.join(lines) + '\n')
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
