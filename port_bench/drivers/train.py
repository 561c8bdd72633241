"""The training cells: one trainer of the port (`RgbTrainer` or
`DepthTrainer`), driven from the seed through its first three steps at
set-up, then for the window over the mix's staged batches.

Every batch goes through the port's own input path as its loaders run
it: the per-batch gate (`warp.split_band_ok` on the host homographies),
`augment.process_color_batch` (the split warp, clip, colour chain when
the recipe has it, normalise), the bbox mask for -extra_channel, and for
the distillation `augment.process_depth_batch` on the raw depth canvases.
The canvases, homographies, draws and ground truth are staged on the
card at set-up, so inside the window only the port runs.

The step object's first three steps are the ones compared with the
reference: their losses (a recording wrapper around the trainer's step
during set-up only), Adam's first moment after step one and the
parameters after step three (both copied on the stream as the trainer
pulls the next batch, so before step four changes them).
"""

import contextlib
import io
import time

import torch

from port_bench import oracle, trace, traffic as T

WARM_STEPS = 3           # set-up steps, all compared with the reference
TRACE_STEPS = 6          # steps of the profiled slice of a --trace 1 run


class Feed:
    """An epoch of the port's input path over staged batches: up to
    `count` batches, or until `deadline` (host clock) passes, cycling
    through `items`. `on_pull(i)` runs as batch i is asked for (steps
    0..i-1 are then dispatched); `spans` collects each batch's host
    seconds in the input path."""

    def __init__(self, items, make, count=None, deadline=None,
                 on_pull=None, spans=None, first=0):
        self.items, self.make = items, make
        self.count, self.deadline = count, deadline
        self.on_pull, self.spans = on_pull, spans
        self.first = first
        self.n = 0
        self.used = []

    def __iter__(self):
        i = 0
        while True:
            if self.on_pull is not None:
                self.on_pull(i)
            if self.count is not None and i >= self.count:
                return
            if self.deadline is not None and \
                    time.perf_counter() >= self.deadline:
                return
            k = (self.first + i) % len(self.items)
            t0 = time.perf_counter()
            with torch.profiler.record_function('port_bench.input'):
                batch = self.make(self.items[k])
            if self.spans is not None:
                self.spans.append(time.perf_counter() - t0)
            self.used.append(k)
            self.n += 1
            yield batch
            i += 1


def _draws(colour):
    from pose_tpu_torch.data import augment
    return augment.AugmentDraws(colour, *([None] * 7))


def rgb_batch(args, colour_chain):
    """The RGB loader's device batch from a staged item."""
    from pose_tpu_torch.data import augment
    from pose_tpu_torch.ops import warp

    side = args.side_in

    def make(it):
        impl = ('split' if warp.split_band_ok(it['homs_host'], (side, side))
                else 'mxu')
        crops = augment.process_color_batch(
            it['canvases'], it['homs'], it['extents'],
            _draws(it['colour']) if colour_chain else None, side,
            colour_chain, False, warp_impl=impl)
        if args.extra_channel:
            crops = torch.cat([crops, augment.bbox_mask_channel(
                it['quads'], side)], -1)
        return dict(image=crops, true_cam=it['true_cam'],
                    true_mat=it['true_mat'], true_val=it['true_val'],
                    intrinsics=it['intrinsics'])
    return make


def distill_batch(args, colour_chain):
    """The depth loader's device batch (colour and depth streams) from a
    staged item."""
    from pose_tpu_torch.data import augment
    from pose_tpu_torch.ops import warp

    side = args.side_in
    thresh = None

    def gate(homs):
        return ('split' if warp.split_band_ok(homs, (side, side))
                else 'mxu')

    def make(it):
        nonlocal thresh
        if thresh is None:
            thresh = torch.full((len(it['homs_host']),), 0.1,
                                device=it['canvases'].device)
        colour = augment.process_color_batch(
            it['canvases'], it['homs'], it['extents'],
            _draws(it['colour']) if colour_chain else None, side,
            colour_chain, False, warp_impl=gate(it['homs_host']))
        depth = augment.process_depth_batch(
            it['depth_canvases'], it['depth_homs'], it['depth_extents'],
            it['k_invs'], thresh, side, args.nexponent, args.to_depth,
            warp_impl=gate(it['depth_homs_host']))
        return dict(color=colour, depth=depth, true_cam=it['true_cam'],
                    true_val=it['true_val'], atten_map=it['atten_map'])
    return make


class Trainer:
    """The port's trainer for a configuration, with its step's slot (the
    cached step function the epoch loop calls) and its batch maker."""

    def __init__(self, cfg, traffic, seed, device):
        from pose_tpu_torch.models import build_model
        from pose_tpu_torch.train import (default_depth_args,
                                          default_train_args, depth_engine,
                                          engine)

        self.kind = cfg['kind']
        over = dict(cfg['train_args'], batch_size=traffic['batch_size'])
        info = engine.JointInfo(None, None, None, cfg['key_index'])
        colour_chain = traffic['colour_chain']
        student = oracle.role_weights(cfg, 'train', seed, device)
        if self.kind == 'rgb':
            args = default_train_args(**over)
            with torch.device(device):
                model = build_model(args)
            model.load_state_dict(student, strict=True)
            self.trainer = engine.RgbTrainer(args, model, info, device=device)
            self.slot, self.key = (self.trainer._joint_steps,
                                   bool(args.do_track and
                                        traffic['epoch'] != 1))
            self.trainer._get_joint_step(self.key)
            self.make = rgb_batch(args, colour_chain)
        elif self.kind == 'distill':
            args = default_depth_args(**over)
            student_args = type(args)(**dict(vars(args), depth_only=False))
            with torch.device(device):
                model = build_model(student_args, 'depth')
                teacher = build_model(args, 'fusion')
            model.load_state_dict(student, strict=True)
            teacher.load_state_dict(
                oracle.role_weights(cfg, 'teacher', seed, device),
                strict=True)
            self.trainer = depth_engine.DepthTrainer(
                args, model, info, thresh=150.0, device=device)
            self.trainer.set_teacher(teacher)
            self.slot, self.key = self.trainer._steps, 'distill'
            self.trainer._step('distill')
            self.make = distill_batch(args, colour_chain)
        else:
            raise ValueError(f'unknown training kind {self.kind!r}')
        del student

    @contextlib.contextmanager
    def wrapped_step(self, wrap):
        """The trainer's step replaced by wrap(step) for the block."""
        step = self.slot[self.key]
        self.slot[self.key] = wrap(step)
        try:
            yield
        finally:
            self.slot[self.key] = step

    def epoch(self, epoch, feed, console):
        with contextlib.redirect_stdout(console):
            return self.trainer.train(epoch, feed)


def _recorder(outs):
    def wrap(step):
        def recorded(*a, **kw):
            out = step(*a, **kw)
            outs.append(out)
            return out
        return recorded
    return wrap


def _timer(spans):
    def wrap(step):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = step(*a, **kw)
            spans.append(time.perf_counter() - t0)
            return out
        return timed
    return wrap


def run(ctx):
    """One run of a training cell (see run.py for `ctx`)."""
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    console = io.StringIO()
    pool = T.train_batches(traffic, cfg, ctx.seed, dev)
    tr = Trainer(cfg, traffic, ctx.seed, dev)
    state = tr.trainer.state
    names = [n for n, _ in tr.trainer.model.named_parameters()]
    epoch = traffic['epoch']
    snap = {}

    def on_pull(i):
        if i == 1:
            snap['mu'] = {n: m.clone() for n, m in zip(names, state.tx.mu)}
        if i == WARM_STEPS:
            snap['params'] = {n: p.detach().clone() for n, p in
                              zip(names, state.tx.params)}

    outs = []
    ctx.faults.get('trainer', lambda t: None)(tr)
    make = ctx.faults.get('batch', lambda f: f)(tr.make)
    with tr.wrapped_step(_recorder(outs)):
        tr.epoch(epoch, Feed(pool, make, count=WARM_STEPS,
                             on_pull=on_pull), console)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    losses = [{k: float(v) for k, v in o.items()} for o in outs]
    snap = {k: {n: t.cpu() for n, t in v.items()} for k, v in snap.items()}

    ctx.setup_done()
    spans_in, spans_step = [], []
    feed = Feed(pool, make, deadline=ctx.t0 + ctx.seconds,
                spans=spans_in if ctx.trace else None)
    wrap = _timer(spans_step) if ctx.trace else (lambda s: s)
    with tr.wrapped_step(wrap):
        record = tr.epoch(epoch, feed, console)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - ctx.t0
    images = feed.n * traffic['batch_size']
    ctx.attempted = feed.n
    ctx.failed = 0 if all(v == v for v in record.values()) else feed.n
    ctx.end_to_end['train_img_per_s'] = images / wall

    if ctx.trace:
        ctx.spans['input'] = spans_in
        ctx.spans['step'] = spans_step
        sliced = Feed(pool, make, count=TRACE_STEPS, first=feed.n)
        _, ctx.trace_result, _ = trace.profile(
            lambda: tr.epoch(epoch, sliced, console), dev)
        ctx.extra.update(traced_steps=sliced.n,
                         traced_items=[pool[k] for k in sliced.used],
                         batch_size=traffic['batch_size'])
    ctx.read_memory()
    del tr, state, pool, outs
    ctx.free()

    start = oracle.role_weights(cfg, 'train', ctx.seed, dev)
    prog = oracle.program_readings(losses, snap['mu'], snap['params'], start)
    del start, snap
    want = oracle.train_readings(ctx.reference, cfg, traffic, ctx.seed, dev,
                                 n_steps=WARM_STEPS)
    ctx.readings = dict(program=prog, reference=want)
    ctx.numbers = oracle.train_numbers(prog, want)
