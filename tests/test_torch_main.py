"""pose_tpu_torch's RGB entry point held against the JAX package on the
CPU: RgbTrainer.joint_test / cam_test records with the same weights and
batches (f64 and f32), the -pretrain surgery and load, the Logger's
checkpoints and best rule, the option parser, and an in-process run of
pose_tpu_torch.main (resnet18, side 65, stride 32, depth 4, batch 4) on a
fixture store, whose checkpoint JAX's converter reads back."""

import os
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import opts as root_opts
from pose_tpu.data import synthetic as jsynthetic
from pose_tpu.models import PoseResNet as JaxPoseResNet
from pose_tpu.models import convert as jconvert
from pose_tpu.train import JointInfo as JaxJointInfo
from pose_tpu.train import Logger as JaxLogger
from pose_tpu.train import RgbTrainer as JaxRgbTrainer
from pose_tpu.train import steps as jax_steps

from pose_tpu_torch import main as cli
from pose_tpu_torch import opts
from pose_tpu_torch.models import PoseResNet, convert
from pose_tpu_torch.models.convert import state_dict_from_jax
from pose_tpu_torch.train import default_train_args, engine
from pose_tpu_torch.train.logger import Logger

B, SIDE, STRIDE, J, D, KEY = 4, 65, 32, 5, 4, 2
MIRROR = np.array([0, 1, 2, 4, 3])
THRESH = dict(thresh_solid=50.0, thresh_close=100.0, thresh_rough=150.0)


def small_args(**over):
    base = dict(model='resnet18', side_in=SIDE, stride=STRIDE, num_joints=J,
                depth=D, batch_size=B, half_acc=False, bn_impl='xla',
                n_cudas=1, mesh_spatial=1, **THRESH)
    base.update(over)
    return default_train_args(**base)


def jax_model(joint_space):
    return JaxPoseResNet(block='basic', layers=(1, 1, 1, 1), variant='rgb',
                         in_channels=4, stride=STRIDE, num_joints=J, depth=D,
                         joint_space=joint_space)


def drawn_variables(model, seed, in_channels=4):
    """Weights drawn with numpy as test_torch_model draws them (He-normal
    trunk kernels, uniform heads, non-trivial BN affine parameters and
    statistics, so eval BN is not the identity); the tree comes from
    jax.eval_shape (no init run)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.ones((1, SIDE, SIDE, in_channels)),
        train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        head = path[-2].key.endswith('regressor')
        if name == 'kernel' and not head:
            value = rng.normal(0, np.sqrt(2.0 / (shape[0] * shape[1]
                                                 * shape[3])), shape)
        elif head:
            bound = (1.0 / np.sqrt(np.prod(shape[:3])) if name == 'kernel'
                     else 0.01)
            value = rng.uniform(-bound, bound, shape)
        elif name == 'mean':
            value = rng.normal(0, 0.1, shape)
        elif name == 'var':
            value = rng.uniform(0.5, 1.5, shape)
        elif name == 'scale':
            value = rng.uniform(0.5, 1.0, shape)
        else:                                   # BN bias
            value = rng.normal(0, 0.1, shape)
        return value.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_variables(joint_space):
    return drawn_variables(jax_model(joint_space), 50)


def rotation(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.linalg.det(q))


def eval_batches(seed, dtype):
    """Two test batches of 4 rows; the second holds 2 real rows
    (`_true_size`), as the last batch of 6 samples does."""
    rng = np.random.RandomState(seed)
    out = []
    for true_n in (B, 2):
        valid = rng.rand(B, J) > 0.2
        valid[:, KEY] = True
        out.append(dict(
            image=rng.randn(B, SIDE, SIDE, 4).astype(dtype),
            true_cam=(rng.uniform(-300, 300, (B, J, 3))
                      + [0, 0, 3000]).astype(dtype),
            true_mat=rng.uniform(5, 60, (B, J, 2)).astype(dtype),
            true_val=valid,
            intrinsics=np.tile(np.array([[500., 0, 32], [0, 500., 32],
                                         [0, 0, 1]]), (B, 1, 1)).astype(
                dtype),
            back_rotation=np.stack([rotation(rng) for _ in range(B)]).astype(
                dtype),
            _true_size=true_n))
    return out


class Sized(list):
    """A list of batches has a len, as a loader does."""


def _apply_f64(model, params, batch_stats, inputs, train, dtype,
               spatial=None):
    """JAX's eval forward (steps.py:101-120) without its casts to f32."""
    assert not train
    return model.apply({'params': params, 'batch_stats': batch_stats},
                       *inputs, train=False), batch_stats


def jax_records(variables, batches, args, joint_space, dtype):
    """JAX's RgbTrainer test epoch; at f64 with x64 on and the eval step's
    forward in f64 (its _apply casts parameters, inputs and outputs to
    f32)."""
    x64 = dtype == np.float64
    jax.config.update('jax_enable_x64', x64)
    saved = jax_steps._apply
    if x64:
        jax_steps._apply = _apply_f64
    try:
        trainer = JaxRgbTrainer(args, jax_model(joint_space),
                                JaxJointInfo(None, None, MIRROR, KEY))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
        trainer.load_state(jax_steps.TrainState(
            params=v['params'], batch_stats=v['batch_stats'], opt_state=None,
            step=jnp.zeros((), jnp.int32)))
        return trainer.test(1, Sized(batches))
    finally:
        jax_steps._apply = saved
        jax.config.update('jax_enable_x64', False)


def port_records(variables, batches, args, joint_space, dtype):
    model = PoseResNet(block='basic', layers=(1, 1, 1, 1), in_channels=4,
                       stride=STRIDE, num_joints=J, depth=D,
                       joint_space=joint_space, bn_impl='xla')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.to(torch.float64 if dtype == np.float64 else torch.float32)
    trainer = engine.RgbTrainer(args, model,
                                engine.JointInfo(None, None, MIRROR, KEY),
                                device='cpu')
    return trainer.test(1, Sized(batches))


# Relative deviation of each record value, port against JAX. f64: the same
# math in both frameworks (measured <= 7.5e-15); bound 1e-10. f32: XLA:CPU's
# convolutions sum in another order than torch's; measured <= 1.3e-5 on the
# OKS score (exp of a pixel distance, 2.1e-3 in value), 1.5e-6 on the
# reconstructed cam_mean, <= 2e-7 on the losses, distances and AUC, and 0
# on the bucket rates and PCK; bound 1e-4.
BOUND = {np.float64: 1e-10, np.float32: 1e-4}


@pytest.mark.parametrize('dtype', [np.float64, np.float32],
                         ids=['f64', 'f32'])
@pytest.mark.parametrize('mode', ['joint_track', 'cam'])
def test_test_epoch_records_match_jax(mode, dtype, capsys):
    """joint_test with the do_track root solve, and cam_test without
    joint_space: the same record keys, every value within BOUND relative,
    and the reference's console lines. The 2-row last batch weights the
    losses by 2 and its padding rows reach no metric."""
    joint_space = mode == 'joint_track'
    args = small_args(joint_space=joint_space, do_track=joint_space)
    variables = jax_variables(joint_space)
    batches = eval_batches(51, dtype)
    ref = jax_records(variables, batches, args, joint_space, dtype)
    capsys.readouterr()
    got = port_records(variables, batches, args, joint_space, dtype)
    text = capsys.readouterr().out
    assert set(got) == set(ref)
    if joint_space:
        assert {'recon_cam_mean', 'mat_mean', 'score_oks'} <= set(got)
        assert '=>[DETER] cam_mean: ' in text
    else:
        assert '| test Epoch[1] [1/2]  Cam Loss ' in text
    assert '=>[SPEC] cam_mean: ' in text
    for k, v in ref.items():
        assert abs(got[k] - v) <= BOUND[dtype] * max(abs(v), 1e-3), (k, got[k],
                                                                    v)
    # padding rows reach no metric: the records equal those of the batch
    # cut to its real rows
    cut = [dict(b) for b in batches]
    cut[1] = {k: (v[:2] if isinstance(v, np.ndarray) else v)
              for k, v in cut[1].items()}
    alone = port_records(variables, cut, args, joint_space, dtype)
    for k, v in got.items():
        if 'loss' not in k:
            assert abs(alone[k] - v) <= BOUND[dtype] * max(abs(v), 1e-3), k


# ------------------------------------------------------------- -pretrain


def imagenet_state(path):
    """A torchvision-key resnet18 state: the trunk of a 3-channel JAX model
    and a 1000-way fc, as tests/test_e2e.py writes one."""
    model = JaxPoseResNet(block='basic', layers=(2, 2, 2, 2), variant='rgb',
                          in_channels=3, stride=STRIDE, num_joints=19,
                          depth=D)
    state = jconvert.variables_to_torch_state(drawn_variables(model, 42, 3))
    state = {k: val for k, val in state.items()
             if not k.startswith(('cam_regressor', 'mat_regressor'))}
    rng = np.random.RandomState(0)
    state['fc.weight'] = rng.randn(1000, 512).astype(np.float32)
    state['fc.bias'] = rng.randn(1000).astype(np.float32)
    jconvert.save_torch_file(state, path)
    return state


def test_pretrain_matches_jax(tmp_path, capsys):
    """-pretrain -extra_channel into a 4-channel joint_space resnet18: the
    surgery and the load equal JAX's, the same keys reported missing (the
    heads) and unused (fc), 'key [ fc.* ] deleted' printed as JAX does."""
    path = str(tmp_path / 'imagenet.pth')
    imagenet = imagenet_state(path)
    jmodel = JaxPoseResNet(block='basic', layers=(2, 2, 2, 2), variant='rgb',
                           in_channels=4, stride=STRIDE, num_joints=19,
                           depth=D, joint_space=True)
    template = drawn_variables(jmodel, 1)
    args = types.SimpleNamespace(model_path=path, extra_channel=True)
    jreport, report = {}, {}
    ref = jconvert.variables_to_torch_state(jconvert.load_pretrained(
        template, args, 'rgb', report=jreport))
    jtext = capsys.readouterr().out
    model = cli.build_model(cli.opts.parse(
        ['-model', 'resnet18', '-suffix', 's', '-data_name', 'cmu',
         '-save_path', 'p', '-criterion', 'SmoothL1', '-extra_channel',
         '-joint_space', '-stride', str(STRIDE), '-depth', str(D)]), 'rgb')
    model.load_state_dict(state_dict_from_jax(template), strict=True)
    convert.load_pretrained(model, args, report=report)
    assert capsys.readouterr().out == jtext
    assert 'key [ fc.weight ] deleted' in jtext
    sd = model.state_dict()
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert set(report['filled']) == set(jreport['filled'])
    assert set(report['missing']) == set(jreport['missing']) == {
        'cam_regressor.weight', 'cam_regressor.bias',
        'mat_regressor.weight', 'mat_regressor.bias'}
    assert report['unused'] == jreport['unused'] == {'fc.weight', 'fc.bias'}

    conv1 = np.asarray(ref['conv1.weight'])
    np.testing.assert_array_equal(
        convert.surgery_extra_channel(imagenet, conv1)['conv1.weight'],
        jconvert.surgery_extra_channel(imagenet, conv1)['conv1.weight'])
    # a variant's surgery that does not fit the model raises, as in JAX
    # (the fusion manual update keeps the 3-channel conv1)
    with pytest.raises(ValueError, match='missing surgery'):
        convert.load_pretrained(model, args, variant='fusion')
    with pytest.raises(ValueError, match='missing surgery'):
        jconvert.load_pretrained(template, args, 'fusion')


# ----------------------------------------------------------------- Logger


def test_logger_matches_jax(tmp_path):
    """Three epochs of records through both Loggers: model_<E>.pth with the
    same state and the same torch-key tensors, best.pth moving only on a
    strict improvement of auc + pck, and the same train_record."""
    variables = jax_variables(True)
    model = PoseResNet(block='basic', layers=(1, 1, 1, 1), in_channels=4,
                       stride=STRIDE, num_joints=J, depth=D, joint_space=True)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    recs = [(dict(cam_train_loss=3.0), dict(score_auc=0.2, score_pck=0.3,
                                            cam_mean=90.0)),
            (dict(cam_train_loss=2.5), dict(score_auc=0.25, score_pck=0.25,
                                            cam_mean=80.0)),
            (dict(cam_train_loss=2.0), dict(score_auc=0.3, score_pck=0.3,
                                            cam_mean=70.0))]
    loggers = {}
    for name, cls in (('jax', JaxLogger), ('port', Logger)):
        args = types.SimpleNamespace(save_path=str(tmp_path / name),
                                     model='resnet18', suffix='t',
                                     save_record=True, test_only=False,
                                     val_only=False, resume=False)
        loggers[name] = cls(args, None)
        for epoch, (train, test) in enumerate(recs, start=1):
            loggers[name].record(epoch, dict(train), dict(test),
                                 variables if name == 'jax' else model)
    assert loggers['port'].state == loggers['jax'].state
    assert loggers['port'].state['best_epoch'] == 3
    run = {n: os.path.join(str(tmp_path / n), 'resnet18-t')
           for n in loggers}
    load = convert.load_torch_file
    assert load(os.path.join(run['port'], 'best.pth')) == {'best': 3}
    assert load(os.path.join(run['port'], 'train_record.pth')) == load(
        os.path.join(run['jax'], 'train_record.pth'))
    for epoch in (1, 2, 3):
        name = 'model_%d.pth' % epoch
        got = torch.load(os.path.join(run['port'], name), weights_only=True)
        ref = load(os.path.join(run['jax'], name))
        assert got['state'] == ref['state']
        for k, v in ref['model'].items():
            assert got['model'][k].device.type == 'cpu'
            np.testing.assert_array_equal(got['model'][k].numpy(), v)


# -------------------------------------------------------------------- CLI


FLAGSHIP = ['-extra_channel', '-shuffle', '-pretrain', '-static_filter',
            '-joint_space', '-do_track']


def test_opts_parse_as_the_root_parser():
    """cmu_train.sh's flags: the same namespace as the root opts.py."""
    argv = FLAGSHIP + ['-half_acc', '-save_record', '-model', 'resnet50',
                       '-model_path', 'm.pth', '-suffix', 'do_atn_full_ecoov',
                       '-data_name', 'cmu', '-data_root_path', 'r',
                       '-data_down_path', 'd', '-save_path', 's',
                       '-criterion', 'SmoothL1', '-batch_size', '64',
                       '-learn_rate', '2e-5', '-n_cudas', '1']
    assert vars(opts.parse(argv)) == vars(root_opts.parse(argv))


@pytest.mark.parametrize('flag', ['-n_cudas 2', '-mesh_spatial 2',
                                  '-dist_coord h:1'])
def test_unported_flags_raise(flag):
    args = opts.parse(['-model', 'resnet18', '-suffix', 's', '-data_name',
                       'cmu', '-save_path', 'p', '-criterion', 'SmoothL1',
                       '-n_cudas', '1'] + flag.split())
    with pytest.raises(NotImplementedError, match='ROADMAP Queue 1 item'):
        cli.check_ported(args)


@pytest.mark.parametrize('flag', ['-save_every 5', '-save_state',
                                  '-trace_dir t'])
def test_ported_flags_pass_and_parse_as_the_root_parser(flag):
    """-save_every, -save_state and -trace_dir are ported: check_ported
    lets them through, and they parse to the root parser's namespace."""
    argv = ['-model', 'resnet18', '-suffix', 's', '-data_name', 'cmu',
            '-save_path', 'p', '-criterion', 'SmoothL1', '-n_cudas',
            '1'] + flag.split()
    args = opts.parse(argv)
    cli.check_ported(args)
    assert vars(args) == vars(root_opts.parse(argv))


def test_main_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main(['-model', 'resnet18', '-suffix', 's', '-data_name', 'cmu',
                  '-save_path', 'p', '-criterion', 'SmoothL1', '-n_cudas',
                  '1'])


def spec_lines(text):
    return re.findall(r'=>\[SPEC\] cam_mean: [\d.]+\s+\[pck\]: [\d.]+'
                      r'\s+\[auc\]: [\d.]+', text)


def test_cli_trains_with_augmentations_on_a_distorted_store(tmp_path,
                                                            capsys):
    """cmu_train.sh's flags plus -colour -eraser -occluder -occ_path on a
    store of distorted source cameras (4 train, 4 valid): one train step
    through the general lookup, the paste, colour and erase, a test
    epoch, then -val_only with the same SPEC line."""
    meta = jsynthetic.make_cmu_fixture(str(tmp_path / 'store'), num_train=4,
                                       num_valid=4, distorted=True)
    occ = jsynthetic.make_occluder_bank(str(tmp_path / 'occ'))
    save = str(tmp_path / 'save')
    base = ['-model', 'resnet18', '-suffix', 'aug', '-data_name', 'cmu',
            '-num_joints', '19', '-criterion', 'SmoothL1', '-batch_size', '4',
            '-side_in', str(SIDE), '-stride', str(STRIDE), '-depth', str(D),
            '-n_cudas', '0', '-workers', '2', '-metadata_path', meta,
            '-save_path', save, '-extra_channel', '-joint_space',
            '-do_track', '-half_acc', '-shuffle', '-colour', '-eraser',
            '-occluder', '-occ_path', occ, '-occ_count', '4']
    capsys.readouterr()
    run = cli.main(base + ['-geometry', '-save_record', '-n_epochs', '1'],
                   device='cpu')
    trained = spec_lines(capsys.readouterr().out)
    assert len(trained) == 1 and len(run.train) == 1
    assert all(np.isfinite(v) for v in run.train[0].values())
    assert dict(run.train_loader.impl_counts) == {'general': 1}
    assert dict(run.test_loader.impl_counts) == {'general': 1}
    assert run.train_loader._occ_bank is not None
    assert run.test_loader._occ_bank is None
    val = cli.main(base + ['-val_only', '-n_epochs', '1'], device='cpu')
    assert spec_lines(capsys.readouterr().out) == trained
    assert val.test[0]['cam_mean'] == run.test[0]['cam_mean']


def test_cli_trains_checkpoints_and_reloads(tmp_path, capsys):
    """Two epochs of cmu_train.sh's flags at a small size on the CPU (8
    train and 6 valid samples; track from epoch 2; -pretrain from a
    torchvision-key state), then -val_only on the save path: its SPEC line
    is the best epoch's. JAX's load_torch_file + variables_from_torch read
    model_1.pth into a JAX model to the same parameters, and the file
    holds only plain containers and CPU tensors."""
    meta = jsynthetic.make_cmu_fixture(str(tmp_path / 'store'), num_train=8,
                                       num_valid=6)
    ckpt = str(tmp_path / 'imagenet.pth')
    imagenet_state(ckpt)
    save = str(tmp_path / 'save')
    base = ['-model', 'resnet18', '-suffix', 'e2e', '-data_name', 'cmu',
            '-num_joints', '19', '-criterion', 'SmoothL1', '-batch_size', '4',
            '-side_in', str(SIDE), '-stride', str(STRIDE), '-depth', str(D),
            '-learn_rate', '1e-4', '-n_cudas', '1', '-workers', '2',
            '-metadata_path', meta, '-save_path', save, '-model_path', ckpt]
    capsys.readouterr()
    run = cli.main(base + FLAGSHIP + ['-half_acc', '-geometry',
                                      '-save_record', '-n_epochs', '2'],
                   device='cpu')
    text = capsys.readouterr().out
    assert 'key [ fc.weight ] deleted' in text
    assert '=> Start training' in text and '[=] Best:  epoch:' in text
    assert 'Recon Loss' not in text.split('| train Epoch[2]')[0]
    assert '| train Epoch[2] [1/2]' in text and '  Recon Loss: ' in text
    assert [len(r) for r in (run.train, run.test)] == [2, 2]
    trained = spec_lines(text)
    assert len(trained) == 2
    out_dir = os.path.join(save, 'resnet18-e2e')
    for name in ('model_1.pth', 'model_2.pth', 'best.pth',
                 'train_record.pth'):
        assert os.path.exists(os.path.join(out_dir, name)), name
    best = run.logger.state['best_epoch']
    assert convert.load_torch_file(os.path.join(out_dir, 'best.pth')) == {
        'best': best}
    record = convert.load_torch_file(os.path.join(out_dir,
                                                  'train_record.pth'))
    assert len(record['cam_train_loss']) == 2
    assert record['recon_train_loss'][0] == 0.0 < record['recon_train_loss'][1]

    val = cli.main(base + FLAGSHIP + ['-half_acc', '-val_only'],
                   device='cpu')
    text = capsys.readouterr().out
    assert spec_lines(text) == [trained[best - 1]]
    assert val.test[0]['cam_mean'] == run.test[best - 1]['cam_mean']

    ckpt1 = torch.load(os.path.join(out_dir, 'model_1.pth'),
                       weights_only=True)
    assert ckpt1['state']['epoch'] == 1
    jmodel = JaxPoseResNet(block='basic', layers=(2, 2, 2, 2), variant='rgb',
                           in_channels=4, stride=STRIDE, num_joints=19,
                           depth=D, joint_space=True)
    template = drawn_variables(jmodel, 3)
    report = {}
    read = jconvert.variables_from_torch(
        template, jconvert.load_torch_file(
            os.path.join(out_dir, 'model_1.pth'))['model'], report=report)
    assert report['missing'] == [] and report['unused'] == set()
    back = jconvert.variables_to_torch_state(read)
    for k, v in back.items():
        np.testing.assert_array_equal(v, ckpt1['model'][k].numpy(),
                                      err_msg=k)
