"""The readings that the limits of `correct` are set from, on the chip at
the cell's own size, in one process:

    python3 port_bench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 2 [--rates 400,640,...] [--out FILE]

For each seed, a run of the cell (a short window) gives the program's
numbers against the reference. On the first `--control-seeds` seeds the
control (the reference in float8 e4m3, put in the program's place) and,
for training cells, the half-batch fault (the reference over half of
every batch) are read against the same float32 reference. `--rates`
sweeps a serving cell's offered rate instead (the knee). One JSON line a
reading, to standard output and to --out. The benchmark's own runs do
not run this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(n, base=3_141_592_653):
    return [base + 2_654_435_761 * i for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, default=12)
    ap.add_argument('--control-seeds', type=int, default=3)
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--rates', default='')
    ap.add_argument('--out', default='')
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from port_bench import run as R
    R.fix_caches()
    import torch

    from port_bench import oracle, plain

    spec = R.Spec()
    dev = torch.device('cuda', 0)
    out = open(a.out, 'a') if a.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + '\n')
            out.flush()

    def done(ctx):
        ctx.readings.clear()
        ctx.extra.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    w = spec.workload(a.workload)
    if a.rates:
        for rate in [float(r) for r in a.rates.split(',')]:
            res, _, ctx = R.run_cell(spec, a.workload, seeds(1)[0],
                                     a.seconds, 0, dev,
                                     t_start=time.perf_counter(),
                                     traffic_over=dict(rate=rate))
            emit(dict(kind='rate', rate=rate, metrics=res['metrics'],
                      attempted=res['attempted'], failed=res['failed'],
                      counters=ctx.counters))
            done(ctx)
        return 0

    for i, seed in enumerate(seeds(a.seeds)):
        res, rows, ctx = R.run_cell(spec, a.workload, seed, a.seconds, 0,
                                    dev, t_start=time.perf_counter())
        emit(dict(kind='program', seed=seed, correct=res['correct'],
                  numbers=ctx.numbers, metrics=res['metrics'],
                  memory_peak_bytes=res['device']['memory_peak_bytes'],
                  counters=ctx.counters))
        if i < a.control_seeds:
            cfg, want = ctx.cfg, ctx.readings['reference']
            ref = spec.reference(w['config'])
            if 'weights' in ctx.readings:
                ctrl = ref.serve_answers(cfg, ctx.readings['weights'],
                                         ctx.readings['crops'],
                                         q=plain.fp8_e4m3)
                emit(dict(kind='control', seed=seed,
                          numbers=oracle.serve_numbers(ctrl, want)))
            else:
                traffic = ctx.traffic
                prog = ctx.readings['program']
                done(ctx)
                for kind, kw in (('control', dict(control=True)),
                                 ('fault_half_batch',
                                  dict(half_batch=True))):
                    got = oracle.train_readings(ref, cfg, traffic, seed, dev,
                                                **kw)
                    emit(dict(kind=kind, seed=seed,
                              numbers=oracle.train_numbers(got, want)))
                    del got
                    gc.collect()
                    torch.cuda.empty_cache()
                still = dict(prog, change={n: 0.0 for n in prog['change']})
                emit(dict(kind='fault_unchanged_state', seed=seed,
                          numbers=oracle.train_numbers(still, want)))
        done(ctx)
        del ctx
    return 0


if __name__ == '__main__':
    sys.exit(main())
