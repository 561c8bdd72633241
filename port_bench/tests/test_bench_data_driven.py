"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and new entries in BENCHMARK.json, and edits no
file that is there: the harness finds each by its name."""

import json
import os

from conftest import make_tiny, run_tiny

READER = '''"""Steps stepped in the traced slice."""


def read(run):
    return run.extra.get('traced_steps')
'''


def test_new_config_traffic_and_metric_need_no_edit(tmp_path):
    root = make_tiny(str(tmp_path))
    pb = os.path.join(root, 'port_bench')
    with open(os.path.join(pb, 'configs', 'tiny.json')) as f:
        cfg = json.load(f)
    cfg['name'] = 'dummy'
    with open(os.path.join(pb, 'configs', 'dummy.json'), 'w') as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, 'references', 'dummy.py'), 'w') as f:
        f.write('from port_bench.references.rgb_cmu import *  # noqa\n')
    with open(os.path.join(pb, 'traffic', 'tiny_train.json')) as f:
        mix = json.load(f)
    with open(os.path.join(pb, 'traffic', 'dummy_mix.json'), 'w') as f:
        json.dump(dict(mix, batch_size=2, pool=3), f)
    with open(os.path.join(pb, 'metrics', 'dummy_steps.train.py'), 'w') as f:
        f.write(READER)
    with open(os.path.join(pb, 'limits', 'dummy.mix.json'), 'w') as f:
        json.dump({'limits': {'loss_gap': 1.0, 'grad_gap': 1.0,
                              'step_gap': 1.0}}, f)
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    bench['configs'].append(dict(bench['configs'][0], name='dummy',
                                 file='port_bench/configs/dummy.json'))
    bench['workloads'].append(dict(name='dummy.mix', config='dummy',
                                   traffic='dummy_mix', chips=1, why='x'))
    for m in bench['end_to_end']:
        if m['name'] == 'train_img_per_s':
            m['workloads'].append('dummy.mix')
    bench['per_layer'].append(dict(
        name='dummy_steps.train', unit='steps', better='higher',
        source='program_counter', layer='trainer loop and step',
        moves='train_img_per_s', workloads=['dummy.mix']))
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    res, _, ctx = run_tiny(root, 'dummy.mix', trace=1)
    assert ctx.traffic['batch_size'] == 2
    assert res['metrics']['dummy_steps.train']['value'] == 6
    res, _, _ = run_tiny(root, 'dummy.mix')
    assert set(res['metrics']) == {'train_img_per_s', 'setup_s'}
