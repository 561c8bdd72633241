"""The RGB training engine (port of pose_tpu/train/engine.py::RgbTrainer,
train/cam_train/joint_train and test/cam_test/joint_test, with BaseTrainer,
LossMeter, _overlap and back_rotate).

The trainer owns the model on its device (channels_last) and its
TrainState; `train(epoch, batches)` and `test(epoch, batches)` run one
epoch over any iterable of batch dicts (numpy arrays or tensors, NHWC
images; a `data.loader.PoseLoader`), print the reference's console lines
and return its record dict. Every batch's tensors go to the device with
the step's keys only; `_true_size` is the count of real rows of a batch,
and the test epochs weight losses and metrics by it and slice every
per-row output to it, as JAX does (engine.py:443-474).

`MidEpochSaver` writes mid-epoch snapshots under `-save_state -save_every
N` (`state_io`). Not ported yet (ROADMAP): the device mesh and `_shard`
(one card here).
"""

import time

import numpy as np
import torch

from .. import metrics, runtime
from ..ops import recon
from . import schedules, state_io, steps


class JointInfo:
    """Skeleton metadata record (reference utils.py:146-151)."""

    def __init__(self, short_names, parent, mirror, key_index):
        self.short_names = short_names
        self.parent = parent
        self.mirror = mirror
        self.key_index = key_index


def _overlap(dispatched):
    """One-deep pipeline over an epoch (engine.py:30-45): pull item i+1
    from `dispatched`, whose body enqueues a step on the card without
    waiting for it, BEFORE yielding item i to the host's console work, so
    the card runs step i+1 while the host waits on step i's loss."""
    pending = None
    for item in dispatched:
        if pending is not None:
            yield pending
        pending = item
    if pending is not None:
        yield pending


def back_rotate(back_rotation, cam):
    """spec/true rotation back to the original camera (engine.py:83;
    train.py:269-270)."""
    return np.einsum('Bij,BCj->BCi', back_rotation, cam)


def _host(x):
    """A batch or step value as host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class LossMeter:
    """Batch-weighted loss averages accumulated on the device: `add`
    enqueues a multiply-add without waiting; the host waits only when a
    mean is read (engine.py:59-80)."""

    def __init__(self, keys):
        self.sums = {k: None for k in keys}
        self.total = 0

    def add(self, out, weight):
        for k in self.sums:
            term = out[k] * weight
            self.sums[k] = term if self.sums[k] is None else (
                self.sums[k] + term)
        self.total += weight

    def mean(self, key):
        if self.sums[key] is None:
            return 0.0
        return float(self.sums[key]) / max(self.total, 1)


class MidEpochSaver:
    """Mid-epoch snapshots (`-save_state -save_every N`; engine.py:88-186).

    Every N train steps the epoch's continuation goes into the mid-epoch
    sidecar (`state_io`): the TrainState, the trainer's `extra_state()`
    (the distillation teacher's BN buffers, the semi stream's position),
    the loss meters' sums, the loader's epoch counter and the next
    batch. The loaders draw every random number from
    (seed, epoch, batch index), so a restored run replays the rest of the
    epoch bit for bit; the skipped batches are never decoded
    (`loader.start_batch`). The copy to the host is synchronous (the steps
    update the state in place); one background thread writes the file, and
    `close()` waits for it and raises its error. A loader without
    `start_batch` disables the saver with a console note. Each snapshot's
    `copy_ms`, `wait_ms` and `write_ms` go to `trainer.snapshot_log`."""

    def __init__(self, trainer, epoch, data_loader, meters):
        self.trainer = trainer
        self.args = trainer.args
        self.epoch = epoch
        self.loader = data_loader
        self.meters = meters
        self.extra = trainer.extra_state()
        every = int(getattr(self.args, 'save_every', 0) or 0)
        enabled = every > 0 and getattr(self.args, 'save_state', False)
        if enabled and not hasattr(data_loader, 'start_batch'):
            print('=> -save_every: %s cannot fast-forward (no start_batch) '
                  '— mid-epoch checkpointing disabled for this run'
                  % type(data_loader).__name__)
            enabled = False
        self.every = every if enabled else 0
        self.offset = 0
        self._writer = None
        if self.every and trainer._mid_resume_pending:
            trainer._mid_resume_pending = False
            self.offset = self._try_restore()

    def _geometry(self):
        return dict(n_batches=len(self.loader),
                    batch_size=self.loader.batch_size, seed=self.loader.seed)

    def _payload(self):
        """The continuation as host tensors."""
        return dict(
            state=state_io.host_train_state(self.trainer.state),
            extra=state_io.extra_payload(self.extra),
            meters=state_io.to_host({name: dict(sums=m.sums, total=m.total)
                                     for name, m in self.meters.items()}),
            loader_epoch=int(self.loader.epoch), geometry=self._geometry())

    def _try_restore(self):
        res = state_io.restore_mid_epoch(self.args, self.epoch,
                                         self._geometry())
        if res is None:
            return 0
        payload, next_batch = res
        self.trainer.load_state(payload['state'])
        device = self.trainer.device
        for name, m in self.meters.items():
            saved = payload['meters'][name]
            m.sums = {k: None if v is None else v.to(device)
                      for k, v in saved['sums'].items()}
            m.total = saved['total']
        for name, (_, set_) in self.extra.items():
            set_(payload['extra'][name])
        self.loader.set_epoch(payload['loader_epoch'])
        self.loader.start_batch = next_batch
        print('=> Resuming epoch %d from batch %d (mid-epoch sidecar)'
              % (self.epoch, next_batch))
        return next_batch

    def step_done(self, i_batch):
        """Call after train step `i_batch` and its meter update: every N
        steps, copy the continuation to the host and hand it to the
        writer."""
        if self.every and (i_batch + 1) % self.every == 0:
            t0 = time.perf_counter()
            payload = self._payload()
            copy_ms = (time.perf_counter() - t0) * 1e3
            if self._writer is None:
                self._writer = state_io.MidEpochWriter(
                    state_io.mid_epoch_dir(self.args))
            entry = self._writer.save(payload, state_io.mid_epoch_id(
                self.epoch, i_batch + 1))
            entry['copy_ms'] = copy_ms
            self.trainer.snapshot_log.append(entry)

    def close(self):
        """Wait for the last write and raise its error; call at epoch end,
        on the exception path too."""
        if self._writer is not None:
            writer, self._writer = self._writer, None
            writer.close()


class BaseTrainer:
    """What the engines share (engine.py BaseTrainer): the model on its
    device (cuda unless given) in channels_last, its TrainState, and the
    batch helpers."""

    def __init__(self, args, model, data_info, device=None):
        self.args = args
        self.data_info = data_info
        self.device = runtime.resolve_device(device)
        model.to(self.device, memory_format=torch.channels_last)
        self.state = steps.init_state(model, args)
        # set by the entry points on -resume -save_state -save_every; the
        # first epoch's MidEpochSaver consumes it
        self._mid_resume_pending = False
        self.snapshot_log = []

    @property
    def model(self):
        return self.state.model

    def load_state(self, saved):
        """Copy a `state_io.host_train_state` into the TrainState."""
        state_io.load_train_state(self.state, saved)

    def extra_state(self):
        """name -> (getter, setter) of what else a continuation needs
        beside the TrainState; none here."""
        return {}

    def _place(self, batch, keys):
        """The device-bound keys of a batch, on the trainer's device."""
        return {k: torch.as_tensor(batch[k]).to(self.device)
                for k in keys if k in batch}

    @staticmethod
    def _size(batch, key):
        return batch.get('_true_size', len(batch[key]))

    @staticmethod
    def _count(batches):
        return len(batches) if hasattr(batches, '__len__') else -1


class RgbTrainer(BaseTrainer):
    """train.py semantics: cam_train / joint_train + cam_test / joint_test."""

    def __init__(self, args, model, data_info, device=None):
        super().__init__(args, model, data_info, device)
        self.thresh = dict(solid=args.thresh_solid, close=args.thresh_close,
                           rough=args.thresh_rough)
        self._cam_step = None
        self._joint_steps = {}
        self._eval_step = steps.make_rgb_eval_step(args, data_info.key_index)

    def _get_cam_step(self):
        if self._cam_step is None:
            self._cam_step = steps.make_cam_train_step(
                self.args, self.data_info.key_index)
        return self._cam_step

    def _get_joint_step(self, do_track):
        if do_track not in self._joint_steps:
            self._joint_steps[do_track] = steps.make_joint_train_step(
                self.args, self.data_info.key_index, do_track)
        return self._joint_steps[do_track]

    def train(self, epoch, batches):
        lr = schedules.rgb_learn_rate(self.args, epoch)
        if self.args.joint_space:
            return self.joint_train(epoch, batches, lr)
        return self.cam_train(epoch, batches, lr)

    def cam_train(self, epoch, batches, lr):
        step = self._get_cam_step()
        n_batches = self._count(batches)
        freq = getattr(self.args, 'print_freq', 1)
        meter = LossMeter(('cam_loss',))
        saver = MidEpochSaver(self, epoch, batches, {'train': meter})

        def dispatched():
            for i, batch in enumerate(batches, start=saver.offset):
                b = self._size(batch, 'image')
                out = step(self.state, self._place(
                    batch, ('image', 'true_cam', 'true_val')), lr)
                meter.add(out, b)
                saver.step_done(i)
                yield i, out

        try:
            for i, out in _overlap(dispatched()):
                if freq and i % freq == 0:
                    print('| train Epoch[%d] [%d/%d]  Loss %1.4f'
                          % (epoch, i, n_batches, float(out['cam_loss'])))
        finally:
            saver.close()
        loss_avg = meter.mean('cam_loss')
        print('\n=> train Epoch[%d]  Cam Loss: %1.4f\n' % (epoch, loss_avg))
        return dict(cam_train_loss=loss_avg)

    def joint_train(self, epoch, batches, lr):
        do_track = self.args.do_track and (epoch != 1)
        step = self._get_joint_step(do_track)
        n_batches = self._count(batches)
        freq = getattr(self.args, 'print_freq', 1)
        meter = LossMeter(('cam_loss', 'mat_loss', 'recon_loss'))
        saver = MidEpochSaver(self, epoch, batches, {'train': meter})

        def dispatched():
            for i, batch in enumerate(batches, start=saver.offset):
                b = self._size(batch, 'image')
                out = step(self.state, self._place(
                    batch, ('image', 'true_cam', 'true_val', 'true_mat',
                            'intrinsics')), lr)
                meter.add(out, b)
                saver.step_done(i)
                yield i, out

        try:
            for i, out in _overlap(dispatched()):
                if freq and i % freq == 0:
                    message = ('| train Epoch[%d] [%d/%d]'
                               % (epoch, i, n_batches))
                    message += '  Cam Loss: %1.4f' % float(out['cam_loss'])
                    message += '  Mat Loss: %1.4f' % float(out['mat_loss'])
                    if do_track:
                        message += ('  Recon Loss: %1.4f'
                                    % float(out['recon_loss']))
                    print(message)
        finally:
            saver.close()
        cam_avg = meter.mean('cam_loss')
        mat_avg = meter.mean('mat_loss')
        recon_avg = meter.mean('recon_loss')
        message = ('=> train Epoch[%d]  Cam Loss: %1.4f  Mat Loss: %1.4f'
                   % (epoch, cam_avg, mat_avg))
        if do_track:
            message += '  Recon Loss: %1.4f' % recon_avg
        print('\n' + message + '\n')
        return dict(cam_train_loss=cam_avg, mat_train_loss=mat_avg,
                    recon_train_loss=recon_avg)

    def test(self, epoch, batches):
        if self.args.joint_space:
            return self.joint_test(epoch, batches)
        return self.cam_test(epoch, batches)

    def cam_test(self, epoch, batches):
        n_batches = self._count(batches)
        loss_avg, total = 0.0, 0
        cam_stats = []

        def dispatched():
            for i, batch in enumerate(batches):
                b = self._size(batch, 'image')
                out = self._eval_step(self.state, self._place(
                    batch, ('image', 'true_cam', 'true_val')))
                yield i, b, batch, out

        for i, b, batch, out in _overlap(dispatched()):
            cam_loss = float(out['cam_loss'])
            loss_avg += cam_loss * b
            total += b
            true_val = _host(batch['true_val']).astype(bool)[:b]
            rot = _host(batch['back_rotation'])[:b]
            spec_cam = back_rotate(rot, _host(out['spec_cam'])[:b])
            true_cam = back_rotate(rot, _host(batch['true_cam'])[:b])
            cam_stats.append(metrics.analyze(spec_cam, true_cam, true_val,
                                             self.data_info.mirror,
                                             self.thresh))
            print('| test Epoch[%d] [%d/%d]  Cam Loss %1.4f'
                  % (epoch, i, n_batches, cam_loss))
        loss_avg /= max(total, 1)
        record = dict(test_loss=loss_avg)
        record.update(metrics.parse_epoch(cam_stats))
        print('\n=> test Epoch[%d]  Cam Loss: %1.4f\n' % (epoch, loss_avg))
        print('=>[SPEC] cam_mean: %1.3f  [pck]: %1.3f  [auc]: %1.3f\n'
              % (record['cam_mean'], record['score_pck'], record['score_auc']))
        return record

    def joint_test(self, epoch, batches):
        n_batches = self._count(batches)
        cam_avg = mat_avg = 0.0
        total = 0
        mat_stats, cam_stats, det_stats = [], [], []
        do_track = self.args.do_track

        def dispatched():
            for i, batch in enumerate(batches):
                b = self._size(batch, 'image')
                placed = self._place(batch, ('image', 'true_cam', 'true_val',
                                             'true_mat', 'intrinsics'))
                out = self._eval_step(self.state, placed)
                if do_track:
                    # the root solve is dispatched with the step, on the
                    # device (utils.py:296-332 get_deter_cam)
                    out['deter_cam'] = recon.recon_root(
                        out['spec_mat'], out['relat_cam'],
                        placed['intrinsics'])
                yield i, b, batch, out

        for i, b, batch, out in _overlap(dispatched()):
            cam_loss = float(out['cam_loss'])
            mat_loss = float(out['mat_loss'])
            cam_avg += cam_loss * b
            mat_avg += mat_loss * b
            total += b
            print('| test Epoch[%d] [%d/%d]  Cam Loss: %1.4f  Mat Loss: %1.4f'
                  % (epoch, i, n_batches, cam_loss, mat_loss))
            true_val = _host(batch['true_val']).astype(bool)[:b]
            mat_stats.append(metrics.analyze_mat(
                _host(out['spec_mat'])[:b], _host(batch['true_mat'])[:b],
                true_val, self.args.side_in))
            rot = _host(batch['back_rotation'])[:b]
            spec_cam = back_rotate(rot, _host(out['spec_cam'])[:b])
            true_cam = back_rotate(rot, _host(batch['true_cam'])[:b])
            cam_stats.append(metrics.analyze(spec_cam, true_cam, true_val,
                                             self.data_info.mirror,
                                             self.thresh))
            if do_track:
                deter = back_rotate(rot, _host(out['deter_cam'])[:b])
                det_stats.append(metrics.analyze(deter, true_cam, true_val,
                                                 self.data_info.mirror,
                                                 self.thresh))

        cam_avg /= max(total, 1)
        mat_avg /= max(total, 1)
        record = dict(cam_test_loss=cam_avg, mat_test_loss=mat_avg)
        record.update(metrics.parse_epoch_mat(mat_stats))
        record.update(metrics.parse_epoch(cam_stats))
        print('\n=> test Epoch[%d]  Cam Loss: %1.4f  Mat Loss: %1.4f\n'
              % (epoch, cam_avg, mat_avg))
        print('=> mat_mean: %1.3f  [oks]: %1.3f\n'
              % (record['mat_mean'], record['score_oks']))
        print('=>[SPEC] cam_mean: %1.3f  [pck]: %1.3f  [auc]: %1.3f\n'
              % (record['cam_mean'], record['score_pck'], record['score_auc']))
        if do_track:
            track_rec = metrics.parse_epoch(det_stats)
            print('=>[DETER] cam_mean: %1.3f  [pck]: %1.3f  [auc]: %1.3f\n'
                  % (track_rec['cam_mean'], track_rec['score_pck'],
                     track_rec['score_auc']))
            for key in track_rec:
                record['recon_' + key] = track_rec[key]
        return record
