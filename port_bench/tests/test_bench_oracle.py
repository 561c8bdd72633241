"""What decides `correct`, on the CPU at a tiny size: the reference agrees
with the port's own float32 paths, the float8 control fails, and a run
whose timed path is broken underneath comes out not correct."""

import pytest
import torch

from conftest import run_tiny
from port_bench import oracle, plain

# the port in float32 against the reference in float32: the same
# operations in another order (first-step losses; the first gradient by
# its worst leaf, within 2 % at batch 4 where BN's statistics are of few
# elements); the served answers within 0.05 mm and 0.01 px
F32 = {'loss_gap': 1e-4, 'grad_gap': 0.02, 'relat_gap_mm': 0.05,
       'mat_gap_px': 0.01}


@pytest.mark.parametrize('workload', ['tiny.train', 'tinyd.train'])
def test_reference_agrees_with_the_port_in_float32(tiny_f32, workload):
    _, _, ctx = run_tiny(tiny_f32, workload)
    assert ctx.numbers['loss_gap'] <= F32['loss_gap']
    assert ctx.numbers['grad_gap'] <= F32['grad_gap']


def test_served_answers_agree_in_float32(tiny_f32):
    _, _, ctx = run_tiny(tiny_f32, 'tiny.serve')
    assert ctx.numbers['relat_gap_mm'] <= F32['relat_gap_mm']
    assert ctx.numbers['mat_gap_px'] <= F32['mat_gap_px']


def test_fp8_control_fails_a_train_limit(tiny):
    from port_bench import run as R
    spec = R.Spec(tiny)
    ref = spec.reference('tiny')
    cfg = spec.config('tiny')
    traffic = spec.traffic('tiny_train')
    want = oracle.train_readings(ref, cfg, traffic, 5, torch.device('cpu'))
    got = oracle.train_readings(ref, cfg, traffic, 5, torch.device('cpu'),
                                control=True)
    numbers = oracle.train_numbers(got, want)
    lims = oracle.limits(R.ROOT, 'rgb_cmu.train_b512')
    assert not oracle.judge(numbers, lims)[0], numbers


def test_fp8_control_fails_the_serve_limit(tiny):
    _, _, ctx = run_tiny(tiny, 'tiny.serve')
    from port_bench import run as R
    ref = R.Spec(tiny).reference('tiny')
    r = ctx.readings
    ctrl = ref.serve_answers(ctx.cfg, r['weights'], r['crops'],
                             q=plain.fp8_e4m3)
    numbers = oracle.serve_numbers(ctrl, r['reference'])
    lims = oracle.limits(R.ROOT, 'rgb_cmu.serve_poisson800')
    assert not oracle.judge(numbers, lims)[0], numbers


def _unchanged(tr):
    tr.trainer.state.tx.step = lambda lr: None


def _half(make):
    def half(it):
        batch = make(it)
        return {k: v[:len(v) // 2] for k, v in batch.items()}
    return half


class _Altered:
    """A predictor whose answers are moved where they are produced, or
    (rows='half') whose batch's second half is answered with its first
    half's rows."""

    def __init__(self, p, rows=None):
        self._p, self._rows = p, rows

    def __getattr__(self, name):
        return getattr(self._p, name)

    def _run(self, inputs):
        if self._rows is None:
            out = self._p._run(inputs)
            out['relat_cam'] = out['relat_cam'] + 100.0
            return out
        n = inputs[0].shape[0] // 2
        out = self._p._run(tuple(x[:n].repeat(2, *([1] * (x.dim() - 1)))
                                 for x in inputs))
        return out


@pytest.mark.parametrize('workload,faults', [
    ('tiny.train', {'trainer': _unchanged}),
    ('tiny.train', {'batch': _half}),
    ('tinyd.train', {'trainer': _unchanged}),
    ('tinyd.train', {'batch': _half}),
    ('tiny.serve', {'predictor': lambda p: _Altered(p)}),
    ('tiny.serve', {'predictor': lambda p: _Altered(p, rows='half')}),
], ids=['rgb-unchanged-state', 'rgb-half-batch', 'distill-unchanged-state',
        'distill-half-batch', 'serve-answer-altered', 'serve-half-batch'])
def test_a_broken_timed_path_is_not_correct(tiny, workload, faults):
    """The cell's own limits; the harness's look for a chip skipped."""
    from port_bench import run as R
    real = {'tiny.train': 'rgb_cmu.train_b512',
            'tinyd.train': 'distill_ntu.train_b512',
            'tiny.serve': 'rgb_cmu.serve_poisson800'}[workload]
    # serving: a rate the CPU cannot keep up with, so that batches fill
    over = dict(rate=400) if workload == 'tiny.serve' else None
    _, _, ctx = run_tiny(tiny, workload, faults=faults, traffic_over=over)
    ok, rows = oracle.judge(ctx.numbers, oracle.limits(R.ROOT, real))
    assert not ok, rows
