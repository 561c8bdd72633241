"""The serving cells: single-crop requests into the port's
`BatchingServer` over a `Predictor` (its forward one CUDA graph,
`aot_compile`), offered by an open loop at the mix's fixed rate.

Each request is timed from when it was due to when its future resolved,
so a stall delays the requests behind it; requests due in the window are
waited for up to a minute past its close. The served model's weights are
the seed's, with BN running statistics taken by the plain reference over
the first crops of the pool (so that the eval-mode network normalises as
a trained one does). A sample of the window's answers, drawn from the
seed, is compared with the reference's forward of the same crops.
"""

import time

import numpy as np
import torch

from port_bench import oracle, plain, trace, traffic as T

WAIT_AFTER_S = 60.0
TRACE_S = 3.0             # seconds of the profiled slice of a --trace 1 run
CALIB_CROPS = 64


def served_weights(cfg, seed, pool, device):
    """The seed's weights of the served model with running statistics
    from a train-mode reference forward over the pool's first crops."""
    p = oracle.role_weights(cfg, 'serve', seed, device)
    stats = {}
    plain.no_tf32()
    with torch.no_grad():
        plain.trunk(p, cfg['models']['serve'],
                    pool[:CALIB_CROPS].permute(0, 3, 1, 2).contiguous(),
                    train=True, stats=stats)
    for name, (mean, var) in stats.items():
        p[name + '.running_mean'] = mean
        p[name + '.running_var'] = var
    return p


class Timed:
    """The predictor as the server sees it, with each forward between two
    CUDA events (the traced run's replay time)."""

    def __init__(self, predictor):
        self._p = predictor
        self.events = []

    def __getattr__(self, name):
        return getattr(self._p, name)

    def _run(self, inputs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._p._run(inputs)
        end.record()
        self.events.append((start, end))
        return out


class Offered:
    """An open loop's record: each request's completion time (NaN until
    its future resolves), whether it failed, and the answers of the
    requests in `keep` only. A resolved future is dropped at once, so the
    harness holds no more than the requests in flight."""

    def __init__(self, n, keep=()):
        self.done = np.full(n, np.nan)
        self.failed = np.zeros(n, bool)
        self.keep = set(keep)
        self.answers = {}
        self.pending = {}
        self.late = np.zeros(n)

    def finished(self, i, fut):
        self.done[i] = time.perf_counter()
        if fut.exception() is not None:
            self.failed[i] = True
        elif i in self.keep:
            self.answers[i] = fut.result()
        self.pending.pop(i, None)

    def wait(self, deadline):
        """Until every request resolved or `deadline` (host clock)."""
        for i, fut in list(self.pending.items()):
            try:
                fut.result(timeout=max(deadline - time.perf_counter(), 0.0))
            except Exception:        # recorded by finished()
                pass


def offer(server, pool, due, crops, t0, keep=()):
    """Submit request i at t0 + due[i] with crop crops[i]; returns its
    Offered record."""
    rec = Offered(len(due), keep)
    for i in range(len(due)):
        target = t0 + due[i]
        wait = target - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rec.late[i] = time.perf_counter() - target
        fut = server.submit(pool[crops[i]])
        rec.pending[i] = fut
        fut.add_done_callback(lambda f, i=i: rec.finished(i, f))
    return rec


def run(ctx):
    from pose_tpu_torch import serve

    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    pool = T.serve_crops(traffic, cfg, ctx.seed, dev)
    weights = served_weights(cfg, ctx.seed, pool, dev)
    args = serve.default_args(**cfg['serve_args'])
    with torch.device(dev):
        predictor = serve.Predictor(args, 'rgb', state_dict=weights,
                                    batch_size=traffic['batch_size'],
                                    device=dev)
    timed = ctx.trace and dev.type == 'cuda'
    served = Timed(predictor) if timed else predictor
    served = ctx.faults.get('predictor', lambda p: p)(served)
    server = serve.BatchingServer(served,
                                  max_delay_ms=traffic['max_delay_ms'])
    try:
        # warm-up: the open loop for a second, at the cell's rate
        due, crops = T.arrivals(traffic, 1.0, ctx.seed + 1)
        offer(server, pool, due, crops, time.perf_counter()).wait(
            time.perf_counter() + WAIT_AFTER_S)
        if timed:
            served.events.clear()
        served_before, batches_before = server.served, server.batches

        due, crops = T.arrivals(traffic, ctx.seconds, ctx.seed)
        rng, _ = T.rngs(ctx.seed, 'sample')
        sample = np.sort(rng.choice(len(due), min(traffic['sample'],
                                                  len(due)), replace=False))
        ctx.setup_done()
        rec = offer(server, pool, due, crops, ctx.t0, keep=sample)
        rec.wait(ctx.t0 + ctx.seconds + WAIT_AFTER_S)
        lat = np.where(rec.failed | np.isnan(rec.done), np.inf,
                       rec.done - (ctx.t0 + due))
        ctx.attempted = len(due)
        ctx.failed = int(np.isinf(lat).sum())
        ctx.end_to_end['serve_p95_ms'] = float(np.percentile(lat, 95)) * 1e3
        ctx.counters.update(
            served=server.served - served_before,
            batches=server.batches - batches_before,
            batch_size=traffic['batch_size'],
            late_p95_ms=float(np.percentile(rec.late, 95)) * 1e3)
        if timed:
            torch.cuda.synchronize(dev)
            ctx.spans['replay'] = [s.elapsed_time(e) * 1e-3
                                   for s, e in served.events]
        if ctx.trace:
            before = server.served
            t_due, t_crops = T.arrivals(traffic, TRACE_S, ctx.seed + 2)

            def sliced():
                offer(server, pool, t_due, t_crops, time.perf_counter()).wait(
                    time.perf_counter() + WAIT_AFTER_S)
            _, ctx.trace_result, _ = trace.profile(sliced, dev)
            ctx.extra.update(traced_crops=server.served - before,
                             batch_size=traffic['batch_size'])
    finally:
        server.stop()

    answered = [i for i in sample if i in rec.answers]
    got = {k: torch.as_tensor(np.stack([rec.answers[i][k]
                                        for i in answered])).to(dev)
           for k in ('relat_cam', 'spec_mat')}
    ctx.read_memory()
    del server, served, predictor
    ctx.free()
    picked = pool[torch.as_tensor(crops[answered])]
    want = ctx.reference.serve_answers(cfg, weights, picked)
    ctx.readings = dict(program=got, reference=want, weights=weights,
                        crops=picked)
    ctx.numbers = oracle.serve_numbers(got, want)
