"""One run of one benchmark cell of pose_tpu_torch.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`)
names a configuration (its `file`) and a traffic mix
(`port_bench/traffic/<traffic>.json`), whose `driver` names the module
under `port_bench/drivers/` that runs it. With --trace 0 the result
carries the cell's end-to-end metrics, with --trace 1 its per-layer ones,
each read by `port_bench/metrics/<metric>.py`. The last line of standard
output is the result (JSON); the numbers compared for `correct` are the
last lines of standard error and the result's last key, `checks`.

Exits non-zero with no result where there is no CUDA device, fewer
devices than the cell asks for, or where JAX or the JAX package was
loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, '.port_bench_cache')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pose_tpu')


def fix_caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE,
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
    os.environ.setdefault('USE_FLAX', '0')


def forbidden_modules():
    return sorted({name.split('.')[0] for name in sys.modules
                   if name.split('.')[0] in FORBIDDEN})


def safe(name):
    return name.replace('.', '_').replace('-', '_')


def load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json and the files a cell is found by."""

    def __init__(self, root=ROOT):
        self.root = root
        with open(os.path.join(root, 'BENCHMARK.json')) as f:
            self.bench = json.load(f)

    def workload(self, name):
        for w in self.bench['workloads']:
            if w['name'] == name:
                return w
        raise SystemExit(f'unknown workload {name!r}')

    def config(self, name):
        for c in self.bench['configs']:
            if c['name'] == name:
                with open(os.path.join(self.root, c['file'])) as f:
                    return json.load(f)
        raise SystemExit(f'unknown config {name!r}')

    def traffic(self, name):
        with open(os.path.join(self.root, 'port_bench', 'traffic',
                               f'{name}.json')) as f:
            return json.load(f)

    def metrics_of(self, workload, trace):
        """The metric entries this cell reports: end-to-end ones without a
        trace, per-layer ones with it."""
        entries = self.bench['per_layer' if trace else 'end_to_end']
        e2e = {m['name'] for m in self.bench['end_to_end']
               if 'workloads' not in m or workload in m['workloads']}
        out = []
        for m in entries:
            if 'workloads' in m:
                if workload in m['workloads']:
                    out.append(m)
            elif not trace or m['moves'] in e2e:
                out.append(m)
        return out

    def reference(self, config):
        """The configuration's plain reference,
        `port_bench/references/<config>.py`."""
        return load_file(os.path.join(self.root, 'port_bench', 'references',
                                      f'{config}.py'),
                         'port_bench_reference_' + safe(config))

    def reader(self, metric):
        path = os.path.join(self.root, 'port_bench', 'metrics',
                            f'{metric}.py')
        return load_file(path, 'port_bench_metric_' + safe(metric))


class Context:
    """What a driver gets and fills in: the cell, the seed, the window,
    the device; the end-to-end numbers, spans (seconds), counters, the
    trace, the numbers compared, the memory peak."""

    def __init__(self, cfg, traffic, seed, seconds, trace, device,
                 reference, t_start, faults=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.seconds, self.trace, self.device = seconds, trace, device
        self.reference = reference
        self.t_start = t_start
        self.faults = faults or {}
        self.t0 = None
        self.setup_s = None
        self.end_to_end, self.spans, self.counters, self.extra = {}, {}, {}, {}
        self.trace_result = None
        self.numbers = {}
        self.readings = {}
        self.attempted = self.failed = 0
        self.memory_peak = 0

    def setup_done(self):
        """The window starts: set-up ends here."""
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.t_start

    def read_memory(self):
        import torch
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    def free(self):
        import gc
        import torch
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()


def run_cell(spec, workload, seed, seconds, trace, device, t_start=None,
             faults=None, traffic_over=None):
    """Run a cell in this process; returns (result dict, checks rows, the
    driver's context)."""
    from port_bench import oracle

    w = spec.workload(workload)
    cfg = spec.config(w['config'])
    traffic = dict(spec.traffic(w['traffic']), **(traffic_over or {}))
    driver = importlib.import_module(f'port_bench.drivers.{traffic["driver"]}')
    ctx = Context(cfg, traffic, seed, seconds, trace, device,
                  spec.reference(w['config']),
                  T_START if t_start is None else t_start, faults)
    driver.run(ctx)
    ok, rows = oracle.judge(ctx.numbers, oracle.limits(spec.root, workload))
    correct = ok and ctx.failed == 0
    metrics = {}
    if trace:
        for m in spec.metrics_of(workload, True):
            value = spec.reader(m['name']).read(ctx)
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=m['unit'])
    else:
        ctx.end_to_end['setup_s'] = ctx.setup_s
        for m in spec.metrics_of(workload, False):
            if m['name'] in ctx.end_to_end:
                metrics[m['name']] = dict(value=ctx.end_to_end[m['name']],
                                          unit=m['unit'])
    result = dict(correct=correct, attempted=ctx.attempted,
                  failed=ctx.failed, metrics=metrics,
                  device=device_info(device, w['chips'], ctx))
    if trace and ctx.trace_result is not None:
        result['breakdown'] = ctx.trace_result.breakdown()
    result['checks'] = {name: dict(value=v, limit=lim) for name, v, lim
                        in rows}
    return result, rows, ctx


def device_info(device, chips, ctx):
    import torch
    if device.type != 'cuda':
        return dict(platform='cpu', kind='cpu', count=0,
                    memory_peak_bytes=0)
    info = dict(platform='gpu', kind=torch.cuda.get_device_name(device),
                count=chips, memory_peak_bytes=int(ctx.memory_peak))
    if ctx.trace_result is not None:
        info.update(busy_s=ctx.trace_result.busy_s,
                    window_s=ctx.trace_result.window_s)
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    fix_caches()
    sys.path.insert(0, ROOT)
    spec = Spec()
    chips = spec.workload(a.workload)['chips']

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'port_bench: the cell needs {chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    import pose_tpu_torch  # noqa: F401  (the system under test)
    result, rows, _ = run_cell(spec, a.workload, a.seed, a.seconds, a.trace,
                            torch.device('cuda', 0))
    found = forbidden_modules()
    if found:
        print(f'port_bench: loaded in this process: {", ".join(found)}',
              file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f'check {name} {value!r} limit {limit!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
