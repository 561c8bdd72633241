"""Mid-epoch and full-state checkpoints of pose_tpu_torch on the CPU
(`-save_state`, `-save_every`; train/state_io.py, engine.MidEpochSaver):
the loaders' fast-forward against the uninterrupted epoch and against
JAX's fast-forwarded loaders, byte for byte; an RGB joint+track epoch and
a distillation epoch with a semi stream, preempted and resumed, against
the uninterrupted epoch bit for bit (small models at f64, as the
locksteps); the RGB CLI's `-resume -save_state` against the uninterrupted
run; the snapshot files' rules (write by rename, 2 kept, the geometry
check). The train loaders warp with the gather warp (POSE_TPU_WARP), the
quickest on the CPU: which warp runs is not what a resume can change."""

import copy
import os
import types

import numpy as np
import pytest
import torch

import datasets as root_datasets
from pose_tpu.data import loader as jloader
from pose_tpu.data import synthetic as jsynthetic

from pose_tpu_torch import main as cli
from pose_tpu_torch.data import joints, loader
from pose_tpu_torch.models import PoseResNet, init_weights
from pose_tpu_torch.train import (default_depth_args, default_train_args,
                                  depth_engine, engine, schedules, state_io)

SIDE, STRIDE, D, B = 65, 32, 4, 4


class Preempted(Exception):
    pass


class Feed:
    """A loader's batches with float tensors in f64 (the lockstep tests'
    precision), the first `stop_after` of them and then Preempted, as a
    kill between steps. Attribute reads and writes go to the loader (the
    saver reads its epoch and sets its start_batch)."""

    def __init__(self, inner, stop_after=None):
        self.__dict__.update(_inner=inner, _stop_after=stop_after)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)

    def __len__(self):
        return len(self._inner)

    def __iter__(self):
        for j, batch in enumerate(self._inner):
            if self._stop_after is not None and j >= self._stop_after:
                raise Preempted()
            yield {k: v.double() if isinstance(v, torch.Tensor)
                   and v.is_floating_point() else v
                   for k, v in batch.items()}


@pytest.fixture(autouse=True)
def gather_warp(monkeypatch):
    monkeypatch.setenv('POSE_TPU_WARP', 'gather')


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    """A CMU and an NTU store written by the JAX package's writers: 12
    train samples, 3 batches of 4."""
    root = tmp_path_factory.mktemp('midepoch')
    return types.SimpleNamespace(
        cmu=jsynthetic.make_cmu_fixture(str(root / 'cmu'), num_train=12,
                                        num_valid=4),
        ntu=jsynthetic.make_ntu_fixture(str(root / 'ntu'), num_train=12,
                                        num_valid=4))


def loader_args(meta, kind, **over):
    base = dict(side_in=SIDE, stride=STRIDE, batch_size=B, metadata_path=meta,
                shuffle=True, geometry=True, colour=True, eraser=True,
                occluder=False, occ_path=None, occ_count=0, random_zoom=0.9,
                n_cudas=1, mesh_spatial=1, workers=2, strict_eval=False)
    if kind == 'rgb':
        base.update(num_joints=19, data_name='cmu', joint_space=True,
                    extra_channel=True)
    else:
        base.update(num_joints=17, data_name='ntu', do_teach=True,
                    attention=True, nexponent=True, to_depth=True,
                    joint_space=False, extra_channel=False)
    base.update(over)
    return types.SimpleNamespace(**base)


def host_copy(batch):
    return {k: np.array(v, copy=True) for k, v in batch.items()}


def capture(ld, finalize):
    """Record (i_batch, host batch) at each _finalize of loader `ld`, then
    finalize (or, with finalize False, yield the host batch as is) and
    count the decodes."""
    seen, decoded = [], [0]
    orig_finalize, orig_decode = ld._finalize, ld._decode_batch

    def fin(batch, i_batch, *rest):
        seen.append((i_batch, host_copy(batch)))
        return orig_finalize(batch, i_batch, *rest) if finalize else batch

    def dec(idxs):
        decoded[0] += 1
        return orig_decode(idxs)

    ld._finalize, ld._decode_batch = fin, dec
    return seen, decoded


def same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize('kind', ['rgb', 'depth'])
def test_fast_forward_equals_the_whole_epoch_and_jax(stores, kind):
    """start_batch = 1 in the second epoch (-colour -eraser, so every
    batch's draws count): batches 1.. equal the uninterrupted epoch's
    tail, the skipped batch is never decoded, each batch keeps its index
    (its draws), and start_batch is spent; the host batches (every array
    before the device work: canvases, homographies, GT; the depth stream's
    canvases too) equal JAX's fast-forwarded loader's byte for byte."""
    meta = stores.cmu if kind == 'rgb' else stores.ntu
    port_cls = loader.PoseLoader if kind == 'rgb' else loader.DepthPoseLoader
    jax_cls = jloader.PoseLoader if kind == 'rgb' else jloader.DepthPoseLoader
    info = 'cmu' if kind == 'rgb' else 'h36m'

    def port(start):
        ld = port_cls(loader_args(meta, kind), 'train',
                      joints.build_info(info), device='cpu')
        ld.set_epoch(1)
        ld.start_batch = start
        seen, decoded = capture(ld, True)
        return list(ld), seen, decoded[0], ld

    whole, whole_seen, _, _ = port(0)
    tail, tail_seen, decoded, ld = port(1)
    assert len(whole) == 3 and len(tail) == 2 and decoded == 2
    assert ld.start_batch == 0 and ld.epoch == 2
    assert [i for i, _ in tail_seen] == [1, 2]
    for a, b in zip(whole[1:], tail):
        same_batch(a, b)

    jl = jax_cls(loader_args(meta, kind), 'train',
                 root_datasets.build_info(info))
    jl._native = None
    jl.set_epoch(1)
    jl.start_batch = 1
    jseen, jdecoded = capture(jl, False)
    list(jl)
    assert jdecoded[0] == 2 and jl.start_batch == 0
    assert [i for i, _ in jseen] == [1, 2]
    keys = ('canvas', 'depth_canvas', 'homography', 'depth_homography')
    for (_, got), (_, ref) in zip(tail_seen, jseen):
        assert keys[0] in got and (kind == 'rgb') != (keys[1] in got)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def run_args(defaults, kind, meta, save, **over):
    """A trainer's and its loaders' flags at the small size, with
    -save_state -save_every 1."""
    base = vars(loader_args(meta, kind, colour=False, eraser=False))
    base.update(model='resnet18', depth=D, half_acc=False, bn_impl='xla',
                learn_rate=1e-4, print_freq=0, save_state=True, save_every=1,
                save_path=str(save), suffix='mid', **over)
    return defaults(**base)


def outcome(trainer, record):
    """Everything a continuation must reproduce, as host tensors."""
    state = state_io.host_train_state(trainer.state)
    assert state['count'] > 0 and any(float(m.abs().sum()) > 0
                                      for m in state['mu'])
    return dict(state=state, record=record,
                extra=state_io.extra_payload(trainer.extra_state()))


def same_outcome(a, b):
    """Parameters, BN buffers, mu, nu, count, step, extra state and record
    equal bit for bit."""
    assert a['record'] == b['record']
    sa, sb = a['state'], b['state']
    assert (sa['count'], sa['step']) == (sb['count'], sb['step'])
    assert set(sa['model']) == set(sb['model'])
    for k in sa['model']:
        assert torch.equal(sa['model'][k], sb['model'][k]), k
    for name in ('mu', 'nu'):
        for x, y in zip(sa[name], sb[name]):
            assert torch.equal(x, y), name
    assert set(a['extra']) == set(b['extra'])
    for name, value in a['extra'].items():
        if isinstance(value, dict) and name == 'semi_pos':
            assert value == b['extra'][name]
        else:
            for k in value:
                assert torch.equal(value[k], b['extra'][name][k]), (name, k)


def tiny(variant, in_channels, num_joints, seed, joint_space=False):
    model = PoseResNet(block='basic', layers=(1, 1, 1, 1), variant=variant,
                       in_channels=in_channels, stride=STRIDE,
                       num_joints=num_joints, depth=D,
                       joint_space=joint_space)
    return init_weights(model, torch.Generator().manual_seed(seed)).double()


def test_rgb_joint_track_epoch_preempted_and_resumed_is_bit_equal(
        stores, tmp_path):
    """Epoch 2 of -joint_space -do_track (the track loss on) with
    -save_state -save_every 1, killed after 2 of 3 steps, resumed in a
    fresh trainer from the snapshot: the same parameters, BN buffers, Adam
    moments and counts, and the same epoch record as the uninterrupted
    epoch. Without the snapshot the resumed epoch would start over."""
    info = joints.build_info('cmu')

    def fresh(save):
        args = run_args(default_train_args, 'rgb', stores.cmu, save,
                        n_epochs=2)
        trainer = engine.RgbTrainer(args, tiny('rgb', 4, 19, 3, True), info,
                                    device='cpu')
        return args, trainer, Feed(loader.PoseLoader(args, 'train', info,
                                                     device='cpu'))

    args, trainer, batches = fresh(tmp_path / 'whole')
    whole = outcome(trainer, trainer.train(2, batches))
    assert whole['record']['recon_train_loss'] > 0
    assert len(trainer.snapshot_log) == 3

    args, trainer, batches = fresh(tmp_path / 'cut')
    with pytest.raises(Preempted):
        trainer.train(2, Feed(batches._inner, 2))
    mid = state_io.mid_epoch_dir(args)
    assert sorted(os.listdir(mid)) == ['20000001.pt', '20000002.pt']

    args, trainer, batches = fresh(tmp_path / 'cut')
    trainer._mid_resume_pending = True
    resumed = outcome(trainer, trainer.train(2, batches))
    assert len(batches.log[-1]['decode_ms']) == 1
    same_outcome(whole, resumed)


def test_distill_semi_epoch_preempted_and_resumed_is_bit_equal(stores,
                                                               tmp_path):
    """-do_teach -attention -semi_teach with -save_every 1: a 2-batch semi
    stream of 6 samples wraps inside the 3-step epoch, and the teacher's BN
    statistics drift at every step. Killed after 2 steps and resumed: the
    student's state, the teacher's buffers, the semi stream's position and
    the record equal the uninterrupted epoch's bit for bit."""
    info = joints.build_info('h36m')

    def fresh(save):
        args = run_args(default_depth_args, 'depth', stores.ntu, save,
                        semi_teach=True, save_last=False)
        trainer = depth_engine.DepthTrainer(args, tiny('depth', 3, 17, 4),
                                            info, device='cpu')
        trainer.set_teacher(tiny('depth', 3, 17, 5))
        semi_args = copy.copy(args)
        semi_args.batch_size = 6
        trainer.set_semi_loader(Feed(loader.DepthPoseLoader(
            semi_args, 'train', info, seed=5, device='cpu')))
        return args, trainer, Feed(loader.DepthPoseLoader(
            args, 'train', info, device='cpu'))

    args, trainer, batches = fresh(tmp_path / 'whole')
    lr = schedules.depth_learn_rate(args, 1)
    teacher_before = state_io.to_host(dict(trainer.teacher.named_buffers()))
    whole = outcome(trainer, trainer.distill_train(1, batches, lr))
    assert whole['extra']['semi_pos'] == dict(epoch=1, pulled=1)
    assert not torch.equal(whole['extra']['teacher_buffers'][
        'bn1.running_mean'], teacher_before['bn1.running_mean'])

    args, trainer, batches = fresh(tmp_path / 'cut')
    with pytest.raises(Preempted):
        trainer.distill_train(1, Feed(batches._inner, 2), lr)

    args, trainer, batches = fresh(tmp_path / 'cut')
    trainer._mid_resume_pending = True
    same_outcome(whole, outcome(trainer,
                                trainer.distill_train(1, batches, lr)))


def test_cli_resume_save_state_equals_the_uninterrupted_run(stores,
                                                            tmp_path):
    """The RGB CLI (cmu_train.sh's flags at a small size): 2 epochs with
    -save_state -save_every 1 write full_state/epoch_<E>.pt and clear the
    mid-epoch snapshots once each epoch is recorded. Cut back to what a
    kill after epoch 1 leaves (model_1.pth, the epoch-1 record and
    sidecar), `-resume -save_state` from model_1.pth restores Adam's
    moments, the loader's epoch and the best epoch, and its model_2.pth,
    train_record.pth and epoch_2.pt equal the uninterrupted run's."""
    save = str(tmp_path / 'save')
    argv = ['-model', 'resnet18', '-suffix', 's', '-data_name', 'cmu',
            '-num_joints', '19', '-criterion', 'SmoothL1', '-batch_size', '4',
            '-side_in', str(SIDE), '-stride', str(STRIDE), '-depth', str(D),
            '-learn_rate', '1e-4', '-n_cudas', '0', '-workers', '2',
            '-metadata_path', stores.cmu, '-save_path', save, '-n_epochs',
            '2', '-extra_channel', '-shuffle', '-joint_space', '-do_track',
            '-save_record', '-save_state']
    whole = cli.main(argv + ['-save_every', '1'], device='cpu')
    assert len(whole.trainer.snapshot_log) == 6
    run_dir = os.path.join(save, 'resnet18-s')
    sidecar = os.path.join(run_dir, state_io.SIDECAR)
    assert sorted(os.listdir(sidecar)) == ['epoch_1.pt', 'epoch_2.pt']

    names = ('model_2.pth', 'train_record.pth',
             os.path.join(state_io.SIDECAR, 'epoch_2.pt'))
    ref = {n: state_io.read_file(os.path.join(run_dir, n)) for n in names}
    for n in names[0], names[2]:
        os.remove(os.path.join(run_dir, n))
    torch.save({k: v[:1] for k, v in ref['train_record.pth'].items()},
               os.path.join(run_dir, 'train_record.pth'))

    resumed = cli.main(argv + ['-resume', '-model_path',
                               os.path.join(run_dir, 'model_1.pth')],
                       device='cpu')
    assert resumed.train_loader.epoch == 2
    assert len(resumed.train) == 1 and resumed.train == whole.train[1:]
    for n in names:
        got = state_io.read_file(os.path.join(run_dir, n))
        assert_same_tree(got, ref[n], n)


def assert_same_tree(a, b, where):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same_tree(a[k], b[k], f'{where}/{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f'{where}[{i}]')
    else:
        assert a == b, where


# ------------------------------------------------------- the files' rules


def small_payload(value, **geometry):
    geo = dict(n_batches=3, batch_size=4, seed=0)
    geo.update(geometry)
    return dict(x=torch.full((2,), float(value)), geometry=geo)


def mid_args(tmp_path):
    return types.SimpleNamespace(save_path=str(tmp_path), model='resnet18',
                                 suffix='f')


@pytest.mark.parametrize('key,value', [('batch_size', 8), ('seed', 1),
                                       ('n_batches', 4)])
def test_a_snapshot_of_another_geometry_raises(tmp_path, key, value):
    """A mid-epoch snapshot taken with another batch size, loader seed or
    number of batches cannot resume this epoch: restore raises a
    ValueError naming the field."""
    args = mid_args(tmp_path)
    writer = state_io.MidEpochWriter(state_io.mid_epoch_dir(args))
    writer.save(small_payload(1, **{key: value}),
                state_io.mid_epoch_id(3, 2))
    writer.close()
    geometry = dict(n_batches=3, batch_size=4, seed=0)
    with pytest.raises(ValueError, match=key):
        state_io.restore_mid_epoch(args, 3, geometry)
    # another epoch's snapshot is stale: nothing to restore
    assert state_io.restore_mid_epoch(args, 4, geometry) is None
    with pytest.raises(ValueError, match='id range'):
        state_io.mid_epoch_id(3, state_io.MID_EPOCH_RADIX)


def test_a_kill_before_the_rename_keeps_the_last_snapshot(tmp_path,
                                                          monkeypatch):
    """Snapshots go to a .tmp file and are renamed into place; only the 2
    newest are kept. A write that dies before its rename (here os.replace
    raises, as a kill there would stop it) leaves its .tmp and the
    previous snapshot, which restore takes; the writer raises the write's
    error at close."""
    args = mid_args(tmp_path)
    directory = state_io.mid_epoch_dir(args)
    writer = state_io.MidEpochWriter(directory)
    for batch in (1, 2, 3):
        writer.save(small_payload(batch), state_io.mid_epoch_id(1, batch))
    writer.close()
    assert sorted(os.listdir(directory)) == ['10000002.pt', '10000003.pt']
    assert [e['write_ms'] > 0 for e in writer.log] == [True] * 3

    def killed(src, dst):
        raise OSError('killed before the rename')

    monkeypatch.setattr(state_io.os, 'replace', killed)
    writer.save(small_payload(4), state_io.mid_epoch_id(1, 4))
    with pytest.raises(OSError, match='before the rename'):
        writer.close()
    monkeypatch.undo()
    assert sorted(os.listdir(directory)) == ['10000002.pt', '10000003.pt',
                                             '10000004.pt.tmp']
    payload, next_batch = state_io.restore_mid_epoch(
        args, 1, dict(n_batches=3, batch_size=4, seed=0))
    assert next_batch == 3 and torch.equal(payload['x'],
                                           torch.full((2,), 3.0))
