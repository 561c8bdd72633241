"""The benchmark runs the port and nothing of JAX: no module of
port_bench imports jax, jaxlib, flax or the JAX package (top-level names
compared whole; pose_tpu_torch is the port), and a run of a cell loads
none of them."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'pose_tpu'}


def sources():
    pb = os.path.join(ROOT, 'port_bench')
    for dirpath, _, files in os.walk(pb, followlinks=False):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split('.')[0] not in FORBIDDEN, (path, n)


def test_a_run_loads_no_jax(tiny):
    code = f'''
import sys, time, torch
sys.path.insert(0, {ROOT!r})
torch.set_num_threads(2)
from port_bench import run as R
R.run_cell(R.Spec({tiny!r}), 'tiny.serve', 3, 0.5, 0, torch.device('cpu'),
           t_start=time.perf_counter())
print(','.join(R.forbidden_modules()) or 'none')
'''
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == 'none'


def test_forbidden_names_are_compared_whole():
    from port_bench import run as R
    sys.modules.setdefault('pose_tpu_torch_probe', sys)
    assert 'pose_tpu_torch_probe' not in R.forbidden_modules()
