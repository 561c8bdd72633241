"""The result line: its keys, their order, and no result without a
card."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, run_tiny


def test_result_keys_untraced(tiny):
    res, rows, _ = run_tiny(tiny, 'tiny.train')
    assert list(res) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'checks']
    assert set(res['metrics']) == {'train_img_per_s', 'setup_s'}
    assert set(res['device']) >= {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    assert [r[0] for r in rows] == list(res['checks'])
    json.dumps(res)


def test_result_keys_traced(tiny):
    res, _, _ = run_tiny(tiny, 'tiny.serve', trace=1)
    assert list(res) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'breakdown', 'checks']
    assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}
    assert 'batch_fill.serve' in res['metrics']
    assert 'serve_p95_ms' not in res['metrics']


def _main(cwd, *extra):
    return subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload',
         'rgb_cmu.train_b512', '--seed', str(2 ** 40 + 1), '--seconds', '1',
         '--trace', '0', *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))


def test_no_card_no_result():
    out = _main(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ''


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'port_bench'), tmp_path / 'port_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = _main(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
