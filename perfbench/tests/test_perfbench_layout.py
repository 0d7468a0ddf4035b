"""BENCHMARK.json against the contract's shape, and every cell's files
found by name: configuration, traffic mix and its runner, limits, and the
reader of each per-layer metric it reports."""

import json
import os
import re

import pytest

from perfbench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
BENCH = harness.load_benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['perfbench'] and BENCH['command'][1] == 'perfbench/run.py'
    assert 1 <= BENCH['run_seconds'] <= 51
    assert os.path.getsize(harness.BENCHMARK) <= 64 * 1024


def test_names_and_units():
    names = [c['name'] for c in BENCH['configs']] + CELLS
    metrics = BENCH['end_to_end'] + BENCH['per_layer']
    names += [m['name'] for m in metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(UNIT.match(m['unit']) and m['better'] in ('lower', 'higher') for m in metrics)
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert e2e['setup_s']['bound'] <= 0.25
    assert all(0.01 <= m['bound'] <= 0.25 for m in BENCH['end_to_end'])
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e and '\n' not in m['layer']
        for cell in m.get('workloads', CELLS):
            assert cell in e2e[m['moves']].get('workloads', CELLS)


def four_chip_cells_fit(workloads) -> bool:
    """At most a quarter of the cells, rounded down, ask for 4 chips; one always may."""
    four = sum(1 for w in workloads if w['chips'] == 4)
    return four <= max(1, len(workloads) // 4)


def test_four_chip_cells():
    assert four_chip_cells_fit(BENCH['workloads'])
    seven = [{'chips': 4}] + [{'chips': 1}] * 6
    assert four_chip_cells_fit(seven)
    assert not four_chip_cells_fit([{'chips': 4}] * 2 + [{'chips': 1}] * 5)
    assert four_chip_cells_fit([{'chips': 4}] * 2 + [{'chips': 1}] * 6)


@pytest.mark.parametrize('cell', CELLS)
def test_cell_files_resolve(cell):
    w = harness.workload(BENCH, cell)
    assert w['chips'] in (1, 4) and len(w['why']) <= 200
    cfg = harness.load_json(harness.config_entry(BENCH, w['config'])['file'])
    assert {'source', 'model', 'weights', 'reduced', 'assumed'} <= set(cfg)
    traffic = harness.load_json(os.path.join('perfbench', 'traffic', w['traffic'] + '.json'))
    drv = harness.runner(traffic['runner'])
    assert all(hasattr(drv, f) for f in ('setup', 'window', 'work', 'release', 'numbers',
                                         'control_numbers'))
    limits = harness.load_json(os.path.join('perfbench', 'limits', cell + '.json'))
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in harness.metrics_of(BENCH, 'per_layer', cell):
        assert callable(harness.reader(m['name']).read)
    reported = {m['name'] for m in harness.metrics_of(BENCH, 'end_to_end', cell)}
    assert 'setup_s' in reported and len(reported) >= 2


def test_config_files_are_distinct():
    files = [c['file'] for c in BENCH['configs']]
    assert len(set(files)) == len(files)
    for c in BENCH['configs']:
        assert c['file'].startswith('perfbench/') and c['reduced'] == \
            harness.load_json(c['file'])['reduced']
        assert any(w['config'] == c['name'] for w in BENCH['workloads'])


def test_json_files_parse():
    for sub in ('configs', 'traffic', 'limits'):
        d = os.path.join(harness.HERE, sub)
        for f in os.listdir(d):
            with open(os.path.join(d, f)) as fh:
                json.load(fh)


def test_every_reader_is_used():
    """Each file of metrics/ reads some per-layer metric: the stem of the
    names it is shared by."""
    used = {os.path.basename(harness.reader(m['name']).__file__) for m in BENCH['per_layer']}
    have = {f for f in os.listdir(os.path.join(harness.HERE, 'metrics')) if f.endswith('.py')}
    assert have == used
