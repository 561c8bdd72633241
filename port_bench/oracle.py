"""What decides `correct`: the reference's readings of the same steps or
requests, the numbers compared, and their limits
(`port_bench/limits/<workload>.json`).

Training (the first three steps of the object the window then drives):
- loss_gap: the largest relative gap of any loss of the first step (the
  later steps' losses are chaotic at seeded weights: the least-squares
  root of near-uniform heatmaps is near singular, so float32 against
  float32 in another summation order already parts by tens of percent at
  step three; PERF.md gives the readings);
- grad_gap: the first gradient as the optimizer gets it (clipped, decay
  added; the program's worked out from Adam's first moment after one
  step), by the worst leaf: |norm(program) - norm(reference)| over the
  larger of the reference leaf's norm and the median leaf's;
- step_gap: the parameters' change over the three steps, by the worst
  leaf in the same way, over the leaves whose first reference gradient
  is at least a thousandth of the median leaf's (the others move under
  Adam by round-off alone).
Serving (a sample of the window's requests, drawn from the seed):
- relat_gap_mm and mat_gap_px: the largest gap of any served joint from
  the reference's, in millimetres (root-relative 3D) and pixels (2D).
"""

import json
import os

import torch

from port_bench import plain, traffic as T, weights as W

ADAM_B1 = 0.9
MOVED = 1e-3            # a leaf's first gradient under this share of the
                        # median leaf's is not held to its change


def limits(root, workload):
    with open(os.path.join(root, 'port_bench', 'limits',
                           f'{workload}.json')) as f:
        return json.load(f)['limits']


def role_weights(cfg, role, seed, device):
    """The seed's starting weights of the model that plays `role`."""
    return W.make_weights(cfg['models'][role],
                          T.rngs(seed, 'weights.' + role)[1], device)


def train_readings(ref, cfg, traffic, seed, device, n_steps=3, control=False,
                   half_batch=False):
    """The reference's n_steps steps from the seed's weights and the mix's
    first batches: {'losses': [{name: float}], 'grad': {leaf: norm},
    'change': {leaf: norm}}; `control` rounds every convolution's operands
    to float8 e4m3 (plain.fp8_e4m3), `half_batch` leaves out half of every
    batch (a fault)."""
    plain.no_tf32()
    q = plain.fp8_e4m3 if control else None
    items = T.train_batches(traffic, cfg, seed, device, n=n_steps)
    params = {r: role_weights(cfg, r, seed, device) for r in ref.roles()}
    names = W.trainable(params['train'])
    start = {n: params['train'][n].clone() for n in names}
    for n in names:
        params['train'][n].requires_grad_(True)
    opt = plain.Adam([params['train'][n] for n in names],
                     cfg['train_args']['grad_norm'],
                     cfg['train_args']['weight_decay'])
    epoch = traffic['epoch']
    rows = traffic['batch_size'] // 2 if half_batch else None
    losses = []
    for it in items:
        parts, loss = ref.train_loss(cfg, params, it, epoch, q, rows)
        grads = torch.autograd.grad(loss, [params['train'][n]
                                           for n in names])
        opt.step(list(grads), ref.learn_rate(cfg, epoch))
        losses.append({k: float(v.detach()) for k, v in parts.items()})
        del grads, loss, parts
    grad = dict(zip(names, plain.param_norms(opt.first_grads)))
    change = dict(zip(names, plain.param_norms(
        [params['train'][n].detach() - start[n] for n in names])))
    return dict(losses=losses, grad=grad, change=change)


def program_readings(losses, mu_after_one, params_after, start):
    """The program's readings in the reference's form, from its step
    outputs, Adam's first moment after step one and its parameters after
    the last compared step (dicts by leaf name), and the starting
    weights."""
    grad = {n: float(torch.linalg.vector_norm(mu.double())) / (1 - ADAM_B1)
            for n, mu in mu_after_one.items()}
    change = {n: float(torch.linalg.vector_norm(
        (p.double() - start[n].to(p.device).double())))
        for n, p in params_after.items()}
    return dict(losses=losses, grad=grad, change=change)


def train_numbers(prog, ref):
    """{number: value} comparing the program's readings with the
    reference's (see the module); each leaf number also by the median
    leaf (`_median`), the steadier reading."""
    first, want = prog['losses'][0], ref['losses'][0]
    out = dict(loss_gap=max(plain.relative_gap(first[k], want[k])
                            for k in want if abs(want[k]) > 0))
    names = sorted(ref['grad'])
    want_g = [ref['grad'][n] for n in names]
    floor = plain.median(want_g) * MOVED
    keep = [g >= floor for g in want_g]
    for key, mask in (('grad', None), ('change', keep)):
        got = [prog[key][n] for n in names]
        ref_v = [ref[key][n] for n in names]
        gaps = plain.leaf_gaps(got, ref_v, mask)
        name = 'grad_gap' if key == 'grad' else 'step_gap'
        out[name] = max(gaps)
        out[name + '_median'] = plain.median(gaps)
    return out


def serve_numbers(got, want):
    """{number: value}: the largest gaps over the sampled requests' joints,
    and their 50th and 90th percentiles (`_p50`, `_p90`)."""
    out = {}
    for key, name, axis in (('relat_cam', 'relat_gap_mm', -1),
                            ('spec_mat', 'mat_gap_px', -1)):
        gap = (got[key].float() - want[key].float()).norm(dim=axis)
        gap = gap.flatten().double()
        out[name] = float(gap.max())
        out[name + '_p50'] = float(gap.quantile(0.5))
        out[name + '_p90'] = float(gap.quantile(0.9))
    return out


def judge(numbers, lims):
    """(correct, [(name, value, limit)]): every number that has a limit
    at most it, and finite."""
    rows = [(k, numbers[k], lim) for k, lim in lims.items()]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
