"""The depth, fusion and distillation training engine (port of
pose_tpu/train/depth_engine.py::DepthTrainer; reference depth_train.py).

Three train modes, dispatched by flags as in JAX (depth_engine.py:109-115):
vanilla (one modality: depth under -depth_only, else colour), fusion (the
two-input model) and distill (-do_teach: a teacher's last feature map
distilled into the student, which reads colour; with -semi_teach an extra
unlabelled batch folds into each update). `train(epoch, batches)` runs one
epoch over any iterable of batch dicts (numpy arrays or tensors, NHWC
images: 'color', 'depth', 'atten_map' (B, h, w, 1), 'true_cam',
'true_val'), prints the reference's console lines and returns its record.

`test(epoch, batches)` runs one test epoch (depth_engine.py:274-368): the
fusion model on colour and depth under -do_fusion without -do_teach, else
one input (colour; depth under -depth_only without -do_teach, so a
distilled student always reads colour; the RGB `image` of a no-depth
store), and returns the record of `metrics`; with -save_last each batch's
back-rotated predictions and last feature map (NHWC, as JAX's) are dumped
under `last_path`.

The dataset facts (`no_depth`, the metric `thresh`) come from the store's
metadata.json when args names one, as in JAX (depth_engine.py:54-61), and
from the constructor's arguments otherwise. Every train mode runs a
`MidEpochSaver`; a distillation continuation also carries the teacher's
BN buffers and, under -semi_teach, the semi stream's position
(`extra_state`). Not ported yet (ROADMAP): the device mesh.
"""

import json
import os

import numpy as np
import torch

from .. import metrics
from ..models import convert
from . import schedules, steps
from .engine import (BaseTrainer, LossMeter, MidEpochSaver, _host,
                     _overlap, back_rotate)


def load_metadata(args):
    with open(args.metadata_path) as file:
        return json.load(file)


def save_array(array, i_batch, last_path):
    """utils.save_array (utils.py:45-52): batch_<i>_spec.npy, kept if it
    exists."""
    save_file = os.path.join(last_path, 'batch_' + str(i_batch) + '_spec.npy')
    if os.path.exists(save_file):
        return
    with open(save_file, 'wb') as file:
        np.save(file, array)


def save_tensor(tensor, i_batch, last_path):
    """utils.save_tensor (utils.py:55-65): batch_<i>.npy, kept if it
    exists."""
    os.makedirs(last_path, exist_ok=True)
    save_file = os.path.join(last_path, 'batch_' + str(i_batch) + '.npy')
    if os.path.exists(save_file):
        return
    with open(save_file, 'wb') as file:
        np.save(file, _host(tensor))


class DepthTrainer(BaseTrainer):
    """depth_train.py semantics. The student model is moved to `device`
    (cuda unless given) in channels_last; `set_teacher` does the same for
    the teacher, whose BN running statistics drift in place during
    distillation without -do_freeze."""

    def __init__(self, args, model, data_info, no_depth=False, thresh=None,
                 device=None):
        super().__init__(args, model, data_info, device)
        self.no_depth = no_depth
        self.thresh = thresh
        self.last_path = None
        if getattr(args, 'metadata_path', None):
            metadata = load_metadata(args)
            self.no_depth = metadata['no_depth'][args.data_name]
            self.thresh = metadata['thresholds'][args.data_name]
            self.last_path = os.path.join(
                os.path.dirname(args.metadata_path),
                'last_' + args.data_name, args.suffix)
        self.save_last = getattr(args, 'save_last', False)
        if self.save_last and self.last_path is None:
            raise ValueError('-save_last writes beside the store\'s '
                             'metadata.json: args needs a metadata_path')
        self.teacher = None
        self.semi_loader = None
        self.semi_worker = None
        self._steps = {}
        self._eval_step = steps.make_depth_eval_step(
            args, data_info.key_index,
            fusion=args.do_fusion and not args.do_teach)

    def set_teacher(self, teacher, state=None):
        """The distillation teacher, on the trainer's device; `state`, a
        torch-key state (-teacher_path's 'model'), is loaded into it first
        (depth_main.py:100-106)."""
        if state is not None:
            convert.load_state(teacher, state, verbose=False)
        teacher.to(self.device, memory_format=torch.channels_last)
        self.teacher = teacher

    def set_semi_loader(self, loader):
        self.semi_loader = loader
        self.semi_worker = iter(loader)
        self._semi_pulled = 0   # batches taken in the current cycle

    def _next_semi_batch(self):
        try:
            batch = next(self.semi_worker)
        except StopIteration:
            self.semi_worker = iter(self.semi_loader)
            self._semi_pulled = 0
            batch = next(self.semi_worker)
        self._semi_pulled += 1
        return batch

    # the semi stream's position is part of a continuation; a restore
    # replays it through the loader's fast-forward (depth_engine.py:95-105)
    def _get_semi_pos(self):
        return dict(epoch=int(self.semi_loader.epoch),
                    pulled=int(self._semi_pulled))

    def _set_semi_pos(self, pos):
        self.semi_loader.set_epoch(int(pos['epoch']))
        self.semi_loader.start_batch = int(pos['pulled'])
        self.semi_worker = iter(self.semi_loader)
        self._semi_pulled = int(pos['pulled'])

    def _get_teacher_buffers(self):
        return dict(self.teacher.named_buffers())

    def _set_teacher_buffers(self, saved):
        buffers = dict(self.teacher.named_buffers())
        if set(saved) != set(buffers):
            raise ValueError('the saved teacher buffers are not this '
                             "teacher's")
        with torch.no_grad():
            for name, value in saved.items():
                buffers[name].copy_(value)

    def extra_state(self):
        """Under -do_teach the teacher's BN buffers (they drift at every
        step without -do_freeze) and, with -semi_teach, the semi stream's
        position."""
        extra = {}
        if self.args.do_teach and self.teacher is not None:
            extra['teacher_buffers'] = (self._get_teacher_buffers,
                                        self._set_teacher_buffers)
        if self.args.semi_teach and self.semi_loader is not None:
            extra['semi_pos'] = (self._get_semi_pos, self._set_semi_pos)
        return extra

    def _step(self, mode):
        """The 'vanilla', 'fusion' or 'distill' step, made at first use."""
        if mode not in self._steps:
            key = self.data_info.key_index
            if mode == 'distill':
                self._steps[mode] = steps.make_distill_train_step(
                    self.args, key, teacher_is_fusion=self.args.do_fusion,
                    with_semi=self.args.semi_teach)
            else:
                factory = getattr(steps, f'make_{mode}_train_step')
                self._steps[mode] = factory(self.args, key)
        return self._steps[mode]

    def train(self, epoch, batches):
        lr = schedules.depth_learn_rate(self.args, epoch)
        if self.args.do_teach:
            return self.distill_train(epoch, batches, lr)
        if self.args.do_fusion:
            return self.fusion_train(epoch, batches, lr)
        return self.vanilla_train(epoch, batches, lr)

    def _single_loss_epoch(self, epoch, batches, lr, step, place, flush):
        n_batches = self._count(batches)
        freq = getattr(self.args, 'print_freq', 1)
        meter = LossMeter(('cam_loss',))
        saver = MidEpochSaver(self, epoch, batches, {'train': meter})

        def dispatched():
            for i, batch in enumerate(batches, start=saver.offset):
                device_batch, b = place(batch)
                out = step(self.state, device_batch, lr)
                meter.add(out, b)
                saver.step_done(i)
                yield i, out

        try:
            for i, out in _overlap(dispatched()):
                if freq and i % freq == 0:
                    print('| train Epoch[%d] [%d/%d]  Loss %1.4f'
                          % (epoch, i, n_batches, float(out['cam_loss'])),
                          flush=flush)
        finally:
            saver.close()
        loss_avg = meter.mean('cam_loss')
        print('\n=> train Epoch[%d]  Cam Loss: %1.4f\n' % (epoch, loss_avg))
        return dict(cam_train_loss=loss_avg)

    def vanilla_train(self, epoch, batches, lr):
        key = 'depth' if self.args.depth_only else 'color'

        def place(batch):
            device_batch = self._place(batch, (key, 'true_cam', 'true_val'))
            device_batch['in_image'] = device_batch.pop(key)
            return device_batch, self._size(batch, key)

        return self._single_loss_epoch(epoch, batches, lr,
                                       self._step('vanilla'), place, True)

    def fusion_train(self, epoch, batches, lr):
        def place(batch):
            return (self._place(batch, ('color', 'depth', 'true_cam',
                                        'true_val')),
                    self._size(batch, 'color'))

        return self._single_loss_epoch(epoch, batches, lr,
                                       self._step('fusion'), place, False)

    def distill_train(self, epoch, batches, lr):
        if self.teacher is None:
            raise RuntimeError('distill_train needs set_teacher() first')
        step = self._step('distill')
        semi = self.args.semi_teach
        alpha = schedules.dist_weight(self.args, epoch)
        print('\n=> alpha value: {:.2f}'.format(alpha))
        n_batches = self._count(batches)
        freq = getattr(self.args, 'print_freq', 1)
        cam_meter = LossMeter(('cam_loss',))
        dist_meter = LossMeter(('dist_loss',))
        keys = ('color', 'depth', 'true_cam', 'true_val', 'atten_map')
        saver = MidEpochSaver(self, epoch, batches,
                              {'cam': cam_meter, 'dist': dist_meter})

        def dispatched():
            for i, batch in enumerate(batches, start=saver.offset):
                full_batch = self._size(batch, 'color')
                device_batch = self._place(batch, keys)
                if semi:
                    extra = self._next_semi_batch()
                    semi_size = extra.get('_true_size', len(extra['color']))
                    out = step(self.state, self.teacher, device_batch, lr,
                               alpha, self._place(extra, ('color', 'depth',
                                                          'atten_map')))
                else:
                    out = step(self.state, self.teacher, device_batch, lr,
                               alpha)
                cam_meter.add(out, full_batch)
                dist_meter.add({'dist_loss': out['dist_loss']}, full_batch)
                if semi:
                    dist_meter.add({'dist_loss': out['semi_loss']},
                                   semi_size)
                saver.step_done(i)
                yield i, out

        try:
            for i, out in _overlap(dispatched()):
                if freq and i % freq == 0:
                    message = '[=] train Epoch[{0}] Batch[{1}|{2}] '.format(
                        epoch, i, n_batches)
                    message += ' Cam Loss {:.4f} '.format(
                        float(out['cam_loss']))
                    message += ' Dist Loss {:.4f} '.format(
                        float(out['dist_loss']))
                    if semi:
                        message += ' Semi Loss {:.4f}'.format(
                            float(out['semi_loss']))
                    print(message)
        finally:
            saver.close()
        cam_loss = cam_meter.mean('cam_loss')
        dist_loss = dist_meter.mean('dist_loss')
        print('\n=> train Epoch[%d]  Cam Loss: %1.4f  Dist Loss: %1.4f\n\n'
              % (epoch, cam_loss, dist_loss))
        return dict(dist_train_loss=dist_loss, cam_train_loss=cam_loss)

    # ------------------------------------------------------------ evaluation

    def test(self, epoch, batches):
        if self.args.do_fusion and not self.args.do_teach:
            return self.fusion_test(epoch, batches)
        return self.vanilla_test(epoch, batches)

    def fusion_test(self, epoch, batches):
        return self._test_loop(epoch, batches, fusion=True)

    def vanilla_test(self, epoch, batches):
        return self._test_loop(epoch, batches, fusion=False)

    def _eval_batches(self, batches, fusion):
        """Yield (size, device batch, batch), adapting no-depth stores
        (depth_engine.py:279-308; depth_train.py:28-37)."""
        for batch in batches:
            if fusion:
                device_batch = self._place(batch, ('color', 'depth',
                                                   'true_cam', 'true_val'))
                size = self._size(batch, 'color')
            else:
                if self.no_depth:
                    key = 'image' if 'image' in batch else 'color'
                else:
                    # a distilled student reads colour (depth_train.py:193):
                    # -depth_only shapes the teacher only (JAX's adjudicated
                    # reading of the reference's -do_teach -depth_only)
                    use_depth = (self.args.depth_only
                                 and not self.args.do_teach)
                    key = 'depth' if use_depth else 'color'
                device_batch = self._place(batch, (key, 'true_cam',
                                                   'true_val'))
                device_batch['in_image'] = device_batch.pop(key)
                size = self._size(batch, 'color' if 'color' in batch
                                  else 'image')
            yield size, device_batch, batch

    def _test_loop(self, epoch, batches, fusion):
        n_batches = self._count(batches)
        loss_avg, total = 0.0, 0
        cam_stats = []

        def dispatched():
            for i, (b, device_batch, batch) in enumerate(
                    self._eval_batches(batches, fusion)):
                out = self._eval_step(self.state, device_batch)
                if not self.save_last:
                    del out['last_feat']
                yield i, b, batch, out

        for i, b, batch, out in _overlap(dispatched()):
            loss = float(out['cam_loss'])
            loss_avg += loss * b
            total += b
            true_val = _host(batch['true_val']).astype(bool)[:b]
            rot = _host(batch['back_rotation'])[:b]
            spec_cam = back_rotate(rot, _host(out['spec_cam'])[:b])
            true_cam = back_rotate(rot, _host(batch['true_cam'])[:b])
            if self.save_last:
                os.makedirs(self.last_path, exist_ok=True)
                save_array(spec_cam, i, self.last_path)
                save_tensor(out['last_feat'][:b].permute(0, 2, 3, 1), i,
                            self.last_path)
            cam_stats.append(metrics.analyze(spec_cam, true_cam, true_val,
                                             self.data_info.mirror,
                                             self.thresh))
            print('| test Epoch[%d] [%d/%d]  Cam Loss %1.4f'
                  % (epoch, i, n_batches, loss))
        loss_avg /= max(total, 1)
        record = dict(test_loss=loss_avg)
        record.update(metrics.parse_epoch(cam_stats))
        print('\n=> test Epoch[%d]  Cam Loss: %1.4f\n' % (epoch, loss_avg))
        print('=>[SPEC] cam_mean: %1.3f  [pck]: %1.3f  [auc]: %1.3f\n'
              % (record['cam_mean'], record['score_pck'], record['score_auc']))
        return record
