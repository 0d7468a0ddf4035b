#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size.

    python3 perfbench/control.py --workload <name> --seeds 12 --control-seeds 3 \
        --seconds 2 [--out FILE]

In one process: for each of --seeds seeds, a short window of the cell's
own traffic through the program (for training, the three checked steps of
set-up) and the check's numbers on what it produced (the lower readings);
for the first --control-seeds of them, the same numbers for the control,
the reference one precision step below the configuration's put in the
program's place on the same inputs, and for each --fault, the program with
that fault planted (the upper readings). Prints one line a reading and, with --out, writes them all
as JSON. A cell on N > 1 cards runs as N ranks, one a card (ranks.py); rank
0 reads the numbers. The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import harness  # noqa: E402

for _k, _v in harness.process_env().items():
    os.environ[_k] = _v


def readings(bench, name, seeds, control_seeds, seconds, device, overrides=None, log=print,
             faults=(), group=None):
    """-> {'program': [{seed, numbers}], 'control': [{seed, numbers}],
    'fault:<name>': [...]}. ``faults`` names entries of the runner's FAULTS
    (context managers that plant a fault in the program) to read on the
    first control_seeds seeds. With ``group`` (ranks.Group) this is one
    rank of a multi-card cell: every rank steps, rank 0 alone reads the
    numbers, and the other ranks return None."""
    cell = harness.workload(bench, name)
    cfg = harness.load_json(harness.config_entry(bench, cell['config'])['file'])
    cfg['name'] = cell['config']
    traffic = harness.load_json(os.path.join('perfbench', 'traffic', cell['traffic'] + '.json'))
    traffic.update(overrides or {})
    drv = harness.runner(traffic['runner'])
    fresh = getattr(drv, 'CHECKED_IN_SETUP', False)    # the checked steps run in set-up
    kw = {'group': group} if group else {}
    lead = group is None or group.lead
    ctx = None if fresh else drv.setup(cfg, traffic, seeds[0], device, harness.Tracer(False),
                                       **kw)
    out = {'program': [], 'control': []}
    for i, seed in enumerate(seeds):
        c = drv.setup(cfg, traffic, seed, device, harness.Tracer(False), **kw) if fresh \
            else ctx._replace(seed=seed)
        win = drv.window(c, seconds)
        if lead:
            timing = {}
            nums = drv.numbers(c, win.samples, timing)
            out['program'].append({'seed': seed, 'numbers': nums, 'counts': win.counts,
                                   'reference_s': timing})
            log(f'program seed {seed}: {json.dumps(nums)} ({json.dumps(win.counts)}; '
                f'reference s {json.dumps(timing)})')
            if i < control_seeds:
                nums = drv.control_numbers(c, win.samples)
                out['control'].append({'seed': seed, 'numbers': nums})
                log(f'control seed {seed}: {json.dumps(nums)}')
        if fresh:
            drv.release(c)
        for fault in faults if i < control_seeds else ():
            with drv.FAULTS[fault]():
                c = drv.setup(cfg, traffic, seed, device, harness.Tracer(False), **kw)
            if lead:
                nums = drv.numbers(c, [], {})
                out.setdefault('fault:' + fault, []).append({'seed': seed, 'numbers': nums})
                log(f'fault {fault} seed {seed}: {json.dumps(nums)}')
            drv.release(c)
    return out if lead else None


def readings_on_ranks(bench, name, seeds, control_seeds, seconds, device_type, overrides=None,
                      faults=(), verbose=True):
    """readings() of a multi-card cell, as many ranks as it asks for cards
    (on the CPU: gloo ranks) -> rank 0's readings, or None if a rank failed."""
    from perfbench import ranks
    world = harness.workload(bench, name)['chips']
    return ranks.spawn(ranks.rank_readings, world, device_type,
                       (bench, name, seeds, control_seeds, seconds, overrides, tuple(faults),
                        verbose), None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, default=12)
    ap.add_argument('--control-seeds', type=int, default=3)
    ap.add_argument('--first-seed', type=int, default=3_000_000_001)
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--fault', action='append', default=[],
                    help="a fault of the runner's FAULTS to plant and read (repeatable)")
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    import torch
    bench = harness.load_benchmark()
    chips = harness.workload(bench, args.workload)['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'control: the cell needs {chips} CUDA card(s)', file=sys.stderr)
        return 2
    t = time.perf_counter()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    if chips == 1:
        torch.cuda.set_device(0)
        res = readings(bench, args.workload, seeds, args.control_seeds, args.seconds,
                       torch.device('cuda', 0), faults=args.fault)
    else:
        res = readings_on_ranks(bench, args.workload, seeds, args.control_seeds, args.seconds,
                                'cuda', faults=args.fault)
        if res is None:
            return 1
    res['workload'], res['device'] = args.workload, harness.power_limit()
    res['seconds'] = time.perf_counter() - t
    for kind in [k for k in res if k == 'program' or k == 'control' or k.startswith('fault:')]:
        for key in res[kind][0]['numbers']:
            vals = [r['numbers'][key] for r in res[kind]]
            print(f'{kind} {key}: min {min(vals)!r} max {max(vals)!r}')
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
