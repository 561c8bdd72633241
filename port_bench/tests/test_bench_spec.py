"""BENCHMARK.json against the contract's shape, and every file a cell is
found by."""

import json
import os
import re

from conftest import ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys():
    b = bench()
    assert list(b) == ['command', 'paths', 'run_seconds', 'configs',
                       'workloads', 'end_to_end', 'per_layer']
    assert 1 <= b['run_seconds'] <= 51
    assert len(b['command']) <= 32 and all(line(w) for w in b['command'])
    assert 1 <= len(b['paths']) <= 16
    for p in b['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024


def test_names_units_and_keys():
    b = bench()
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and line(c['why']) and line(c['source'])
        assert all(NAME.match(k) for k in c['reduced'])
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4) and line(w['why'])
    names = [m['name'] for m in b['end_to_end'] + b['per_layer']]
    assert len(names) == len(set(names))
    for m in b['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in b['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in SOURCES and line(m['layer'])
    for m in b['end_to_end'] + b['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    assert 'setup_s' in {m['name'] for m in b['end_to_end']}


def test_every_cell_reports_what_it_must():
    b = bench()
    cells = {w['name'] for w in b['workloads']}
    e2e = {m['name']: m for m in b['end_to_end']}
    for m in b['per_layer']:
        assert m['moves'] in e2e
        for w in m.get('workloads', []):
            assert w in cells
            assert w in e2e[m['moves']].get('workloads', [w])
    for w in cells:
        mine = [m for m in b['end_to_end']
                if w in m.get('workloads', [w]) and m['name'] != 'setup_s']
        assert mine, w
        assert any(w in m.get('workloads', []) for m in b['per_layer']), w


def test_cells_find_their_files():
    b = bench()
    configs = {c['name']: c for c in b['configs']}
    pb = os.path.join(ROOT, 'port_bench')
    for w in b['workloads']:
        c = configs[w['config']]
        assert c['file'].startswith('port_bench/')
        with open(os.path.join(ROOT, c['file'])) as f:
            assert json.load(f)['name'] == c['name']
        for path in (('traffic', f'{w["traffic"]}.json'),
                     ('limits', f'{w["name"]}.json'),
                     ('references', f'{w["config"]}.py')):
            assert os.path.isfile(os.path.join(pb, *path)), path
        with open(os.path.join(pb, 'traffic', f'{w["traffic"]}.json')) as f:
            driver = json.load(f)['driver']
        assert os.path.isfile(os.path.join(pb, 'drivers', f'{driver}.py'))
    for m in b['per_layer']:
        assert os.path.isfile(os.path.join(pb, 'metrics',
                                           f'{m["name"]}.py')), m['name']
    files = [c['file'] for c in b['configs']]
    assert len(files) == len(set(files))


def test_fits_the_check_time():
    b = bench()
    cells = 24
    total = ((2 + 14 * cells) * (b['run_seconds'] + 60) + cells * 2 * 90
             + 1200)
    assert total <= 43200
    four = sum(w['chips'] == 4 for w in b['workloads'])
    assert four <= max(1, len(b['workloads']) // 4)
