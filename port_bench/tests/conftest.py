"""A tiny copy of the benchmark for the CPU: the real configurations at
257 -> 65 crops, batches of 4 on 128^2 canvases, a serving rate of 40 a
second, every metric reader and reference the real ones."""

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

RENAME = {'rgb_cmu.train_b512': 'tiny.train',
          'distill_ntu.train_b512': 'tinyd.train',
          'rgb_cmu.serve_poisson800': 'tiny.serve'}
LOOSE = {'tiny.train': {'loss_gap': 1.0, 'grad_gap': 1.0, 'step_gap': 1.0},
         'tinyd.train': {'loss_gap': 1.0, 'grad_gap': 1.0,
                         'step_gap': 1.0},
         'tiny.serve': {'relat_gap_mm': 1e3, 'mat_gap_px': 1e3}}


def _load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def _dump(obj, *parts):
    with open(os.path.join(*parts), 'w') as f:
        json.dump(obj, f)


def make_tiny(root, half_acc=True):
    """The tiny benchmark under `root`; returns root."""
    pb = os.path.join(root, 'port_bench')
    for d in ('configs', 'traffic', 'limits', 'references'):
        os.makedirs(os.path.join(pb, d), exist_ok=True)
    if not os.path.exists(os.path.join(pb, 'metrics')):
        shutil.copytree(os.path.join(ROOT, 'port_bench', 'metrics'),
                        os.path.join(pb, 'metrics'),
                        ignore=shutil.ignore_patterns('__pycache__'))
    for src, dst in (('rgb_cmu', 'tiny'), ('distill_ntu', 'tinyd')):
        cfg = _load('port_bench', 'configs', f'{src}.json')
        for m in cfg['models'].values():
            m['side'] = 65
        cfg['train_args'].update(side_in=65, half_acc=half_acc)
        if 'serve_args' in cfg:
            cfg['serve_args'].update(side_in=65, half_acc=half_acc)
        cfg['name'] = dst
        _dump(cfg, pb, 'configs', f'{dst}.json')
        with open(os.path.join(pb, 'references', f'{dst}.py'), 'w') as f:
            f.write(f'from port_bench.references.{src} import *  # noqa\n')
    for src, dst, over in (
            ('train_b512', 'tiny_train', dict(batch_size=4, canvas=[128, 128],
                                              pool=2)),
            ('distill_b512', 'tiny_distill',
             dict(batch_size=4, canvas=[128, 128], depth_canvas=[106, 128],
                  pool=2)),
            ('serve_poisson800', 'tiny_serve', dict(rate=40, pool=16,
                                                    sample=8))):
        _dump(dict(_load('port_bench', 'traffic', f'{src}.json'), **over),
              pb, 'traffic', f'{dst}.json')
    bench = _load('BENCHMARK.json')
    bench['configs'] = [
        dict(c, name=n, file=f'port_bench/configs/{n}.json')
        for c, n in zip(bench['configs'], ('tiny', 'tinyd'))]
    traffic = {'tiny.train': 'tiny_train', 'tinyd.train': 'tiny_distill',
               'tiny.serve': 'tiny_serve'}
    bench['workloads'] = [
        dict(w, name=RENAME[w['name']],
             config=w['config'].replace('rgb_cmu', 'tiny').replace(
                 'distill_ntu', 'tinyd'),
             traffic=traffic[RENAME[w['name']]])
        for w in bench['workloads']]
    for m in bench['per_layer'] + bench['end_to_end']:
        if 'workloads' in m:
            m['workloads'] = [RENAME[w] for w in m['workloads']]
    _dump(bench, root, 'BENCHMARK.json')
    for w, lim in LOOSE.items():
        _dump({'limits': lim}, pb, 'limits', f'{w}.json')
    return root


@pytest.fixture(scope='session')
def tiny(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp('tiny_bench')))


@pytest.fixture(scope='session')
def tiny_f32(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp('tiny_bench_f32')),
                     half_acc=False)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def run_tiny(root, workload, seed=2 ** 40 + 7, seconds=1.0, trace=0,
             faults=None, traffic_over=None):
    from port_bench import run as R
    import time
    return R.run_cell(R.Spec(root), workload, seed, seconds, trace,
                      torch.device('cpu'), t_start=time.perf_counter(),
                      faults=faults, traffic_over=traffic_over)
