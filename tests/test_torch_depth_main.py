"""pose_tpu_torch's depth entry point held against the JAX package on the
CPU: DepthTrainer's test epochs (vanilla on depth, the distilled student on
colour, fusion) at f64 with the same weights and batches, their -save_last
files, and in-process runs of pose_tpu_torch.depth_main on a JAX-written
NTU store (resnet18, side 65, stride 32, depth 4, batch 4): a fusion
teacher, the distillation into a depth student, -val_only, -semi_teach
with a PKU store, and the flags that are not ported."""

import json
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
from pose_tpu.train import steps as jax_steps
from pose_tpu.train.depth_engine import DepthTrainer as JaxDepthTrainer

from pose_tpu_torch import depth_main, opts
from pose_tpu_torch.data import loader
from pose_tpu_torch.main import check_ported
from pose_tpu_torch.models import PoseResNet
from pose_tpu_torch.models.convert import state_dict_from_jax
from pose_tpu_torch.train import default_depth_args, depth_engine, engine

B, SIDE, STRIDE, J, D, KEY = 4, 65, 32, 5, 4, 2
MIRROR = np.array([0, 1, 2, 4, 3])
THRESH = dict(solid=50.0, close=100.0, rough=150.0)


def store_metadata(root, no_depth=False):
    """A metadata.json with the dataset facts the trainer reads."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, 'metadata.json')
    with open(path, 'w') as f:
        json.dump(dict(no_depth=dict(ntu=no_depth),
                       thresholds=dict(ntu=THRESH)), f)
    return path


def small_args(meta, **over):
    base = dict(model='resnet18', side_in=SIDE, stride=STRIDE, num_joints=J,
                depth=D, batch_size=B, half_acc=False, bn_impl='xla',
                metadata_path=meta, suffix='t', save_last=False, n_cudas=1,
                mesh_spatial=1)
    base.update(over)
    return default_depth_args(**base)


def model_kwargs(variant, in_channels):
    return dict(block='basic', layers=(1, 1, 1, 1), variant=variant,
                in_channels=in_channels, stride=STRIDE, num_joints=J,
                depth=D)


def drawn_variables(model, inputs, seed):
    """Flax variables drawn with numpy at f64 (He-normal kernels, small
    heads, non-trivial BN statistics, so eval BN is not the identity)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), *[jnp.ones((1, SIDE, SIDE, c))
                                 for c in inputs], train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if path[-2].key == 'regressor':
            bound = (1.0 / np.sqrt(np.prod(shape[:3])) if name == 'kernel'
                     else 0.01)
            return rng.uniform(-bound, bound, shape)
        if name.endswith('kernel'):
            return rng.normal(0, np.sqrt(2.0 / (shape[0] * shape[1]
                                                * shape[3])), shape)
        return {'mean': lambda: rng.normal(0, 0.1, shape),
                'var': lambda: rng.uniform(0.5, 1.5, shape),
                'scale': lambda: rng.uniform(0.5, 1.0, shape),
                'bias': lambda: rng.normal(0, 0.1, shape)}[name]()
    return jax.tree_util.tree_map_with_path(draw, shapes)


def rotation(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.linalg.det(q))


def eval_batches(seed):
    """Two f64 test batches of 4 rows; the second holds 2 real rows."""
    rng = np.random.RandomState(seed)
    out = []
    for true_n in (B, 2):
        valid = rng.rand(B, J) > 0.2
        valid[:, KEY] = True
        depth = rng.uniform(0.02, 0.4, (B, SIDE, SIDE, 1))
        depth[rng.rand(B, SIDE, SIDE, 1) < 0.1] = 0.0
        out.append(dict(
            color=rng.randn(B, SIDE, SIDE, 3), depth=depth,
            true_cam=rng.uniform(-300, 300, (B, J, 3)) + [0, 0, 3000],
            true_val=valid,
            back_rotation=np.stack([rotation(rng) for _ in range(B)]),
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


# mode -> (args, variant, input channels of the model)
MODES = {'depth_only': (dict(depth_only=True), 'depth', 1),
         'student': (dict(do_teach=True, depth_only=True), 'depth', 3),
         'fusion': (dict(do_fusion=True), 'fusion', 3)}


def jax_records(variables, batches, args, variant, in_ch):
    jax.config.update('jax_enable_x64', True)
    saved = jax_steps._apply
    jax_steps._apply = _apply_f64
    try:
        trainer = JaxDepthTrainer(args,
                                  JaxPoseResNet(**model_kwargs(variant,
                                                               in_ch)),
                                  JaxJointInfo(None, None, MIRROR, KEY))
        trainer.load_state(jax_steps.TrainState(
            params=variables['params'],
            batch_stats=variables['batch_stats'], opt_state=None,
            step=jnp.zeros((), jnp.int32)))
        return trainer.test(1, Sized(batches))
    finally:
        jax_steps._apply = saved
        jax.config.update('jax_enable_x64', False)


def port_records(variables, batches, args, variant, in_ch):
    model = PoseResNet(**model_kwargs(variant, in_ch)).double()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    trainer = depth_engine.DepthTrainer(
        args, model, engine.JointInfo(None, None, MIRROR, KEY),
        device='cpu')
    return trainer.test(1, Sized(batches))


@pytest.mark.parametrize('mode', list(MODES))
def test_test_epoch_records_match_jax(tmp_path, capsys, mode):
    """vanilla_test on the depth channel (-depth_only), on colour for a
    distilled student (-do_teach -depth_only: JAX's adjudicated reading),
    and fusion_test, at f64 with -save_last: the same record keys, each
    value within 1e-9 relative (measured <= 7.9e-16), the reference's
    console lines; the dumped predictions and last feature maps (NHWC) of
    both batches within 1e-9 of JAX's largest value (measured <= 1.2e-15).
    The 2-row last batch weights the loss by 2 and its padding rows reach
    no metric and no dump."""
    over, variant, in_ch = MODES[mode]
    inputs = (3, 1) if variant == 'fusion' else (in_ch,)
    variables = drawn_variables(JaxPoseResNet(**model_kwargs(variant,
                                                             in_ch)),
                                inputs, 60)
    batches = eval_batches(61)
    recs, dumps = {}, {}
    for name, fn in (('jax', jax_records), ('port', port_records)):
        meta = store_metadata(str(tmp_path / name))
        args = small_args(meta, save_last=True, **over)
        capsys.readouterr()
        recs[name] = fn(variables, batches, args, variant, in_ch)
        text = capsys.readouterr().out
        assert '| test Epoch[1] [1/2]  Cam Loss ' in text
        assert '=>[SPEC] cam_mean: ' in text
        last = os.path.join(str(tmp_path / name), 'last_ntu', 't')
        dumps[name] = {f: np.load(os.path.join(last, f))
                       for f in sorted(os.listdir(last))}
    ref, got = recs['jax'], recs['port']
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-9 * max(abs(v), 1e-3), (k, got[k], v)
    assert list(dumps['port']) == list(dumps['jax']) == [
        'batch_0.npy', 'batch_0_spec.npy', 'batch_1.npy',
        'batch_1_spec.npy']
    for f, r in dumps['jax'].items():
        g = dumps['port'][f]
        assert g.shape == r.shape and g.dtype == r.dtype, f
        assert np.abs(g - r).max() <= 1e-9 * np.abs(r).max(), f
    assert dumps['port']['batch_1_spec.npy'].shape == (2, J, 3)


def test_trainer_reads_the_store_facts(tmp_path):
    """no_depth and the metric thresholds come from metadata.json when
    args names one; -save_last needs it."""
    meta = store_metadata(str(tmp_path), no_depth=True)
    model = PoseResNet(**model_kwargs('depth', 3))
    info = engine.JointInfo(None, None, MIRROR, KEY)
    trainer = depth_engine.DepthTrainer(small_args(meta), model, info,
                                        thresh={'rough': 1.0}, device='cpu')
    assert trainer.no_depth is True and trainer.thresh == THRESH
    assert trainer.last_path == os.path.join(str(tmp_path), 'last_ntu', 't')
    with pytest.raises(ValueError, match='metadata_path'):
        depth_engine.DepthTrainer(small_args(None, save_last=True), model,
                                  info, device='cpu')


# -------------------------------------------------------------------- CLI


def spec_lines(text):
    return re.findall(r'=>\[SPEC\] cam_mean: [\d.]+\s+\[pck\]: [\d.]+'
                      r'\s+\[auc\]: [\d.]+', text)


def imagenet_state(path):
    """A torchvision-key resnet18 state (the trunk of a 3-channel JAX
    model and a 1000-way fc) for -pretrain."""
    model = JaxPoseResNet(block='basic', layers=(2, 2, 2, 2), variant='rgb',
                          in_channels=3, stride=STRIDE, num_joints=17,
                          depth=D)
    state = jconvert.variables_to_torch_state(
        drawn_variables(model, (3,), 42))
    state = {k: v.astype(np.float32) for k, v in state.items()
             if not k.startswith('cam_regressor')}
    rng = np.random.RandomState(0)
    state['fc.weight'] = rng.randn(1000, 512).astype(np.float32)
    state['fc.bias'] = rng.randn(1000).astype(np.float32)
    jconvert.save_torch_file(state, path)


def ntu_flags(meta, save, model_path, suffix):
    """ntu_train.sh's flags at a small size on the CPU."""
    return ['-shuffle', '-half_acc', '-pretrain', '-model', 'resnet18',
            '-model_path', model_path, '-suffix', suffix, '-data_name', 'ntu',
            '-save_path', save, '-criterion', 'SmoothL1', '-num_joints',
            '17', '-depth_range', '1e3', '-loss_div', '1e1', '-n_cudas', '0',
            '-metadata_path', meta, '-batch_size', str(B), '-side_in',
            str(SIDE), '-stride', str(STRIDE), '-depth', str(D),
            '-workers', '2', '-n_epochs', '1', '-learn_rate', '1e-4']


@pytest.fixture(scope='module')
def ntu(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli')
    meta = jsynthetic.make_ntu_fixture(str(root / 'ntu'), num_train=8,
                                       num_valid=6)
    model_path = str(root / 'imagenet.pth')
    imagenet_state(model_path)
    return types.SimpleNamespace(root=root, meta=meta, model_path=model_path)


def jax_template(variant, in_channels, inputs):
    model = JaxPoseResNet(block='basic', layers=(2, 2, 2, 2),
                          variant=variant, in_channels=in_channels,
                          stride=STRIDE, num_joints=17, depth=D)
    return drawn_variables(model, inputs, 7)


def test_cli_teacher_distillation_and_val_only(ntu, capsys):
    """ntu_train.sh's flags: a fusion teacher (-do_fusion, -pretrain
    through the manual update), then -do_teach -do_fusion -attention from
    its model_1.pth into a depth student on colour, then -val_only, which
    reloads model_<n_epochs>.pth and reproduces the trained run's SPEC
    line, and -test_only on the test split; JAX's converter reads both
    checkpoints with no key missing or unused; -resume continues the
    teacher at epoch 2."""
    save = str(ntu.root / 'save')
    capsys.readouterr()
    teach = depth_main.main(ntu_flags(ntu.meta, save, ntu.model_path,
                                      'teacher')
                            + ['-do_fusion', '-save_record'])
    text = capsys.readouterr().out
    assert 'key [ fc.weight ] deleted' in text
    assert '=> valid loader decodes depth with the native pool' in text
    assert isinstance(teach.train_loader, loader.DepthPoseLoader)
    assert len(spec_lines(text)) == 1
    teacher_ckpt = os.path.join(save, 'resnet18-teacher', 'model_1.pth')

    distill = ntu_flags(ntu.meta, save, ntu.model_path, 'student') + [
        '-do_fusion', '-do_teach', '-attention', '-teacher_path',
        teacher_ckpt]
    run = depth_main.main(distill + ['-save_record'])
    text = capsys.readouterr().out
    assert '=> alpha value: 0.10' in text
    assert '[=] train Epoch[1] Batch[1|2]  Cam Loss ' in text
    assert ' Dist Loss ' in text and 'Semi Loss' not in text
    trained = spec_lines(text)
    assert len(trained) == 1
    out_dir = os.path.join(save, 'resnet18-student')
    for name in ('model_1.pth', 'best.pth', 'train_record.pth'):
        assert os.path.exists(os.path.join(out_dir, name)), name
    assert run.train[0]['dist_train_loss'] > 0

    val = depth_main.main(distill + ['-val_only'])
    text = capsys.readouterr().out
    assert ('=> Loads checkpoint from '
            + os.path.join(out_dir, 'model_1.pth')) in text
    assert spec_lines(text) == trained
    assert val.test[0] == run.test[0]
    assert ' cam_mean: ' in text.split('=> Evaluation starts')[1]
    test = depth_main.main(distill + ['-test_only'])
    assert test.test_loader.phase == 'test' and len(test.test) == 1
    assert len(spec_lines(capsys.readouterr().out)) == 1

    # -resume continues the teacher from its checkpoint at epoch 2
    resumed = depth_main.main(
        [a for a in ntu_flags(ntu.meta, save, teacher_ckpt, 'teacher')
         if a != '-pretrain'] + ['-do_fusion', '-resume', '-n_epochs', '2',
                                 '-save_record'])
    text = capsys.readouterr().out
    assert '| train Epoch[2] [0/2]' in text and 'Epoch[1]' not in text
    assert resumed.logger.state['epoch'] == 2
    assert os.path.exists(os.path.join(save, 'resnet18-teacher',
                                       'model_2.pth'))

    for ckpt, variant, in_ch, inputs in (
            (teacher_ckpt, 'fusion', 3, (3, 1)),
            (os.path.join(out_dir, 'model_1.pth'), 'depth', 3, (3,))):
        written = torch.load(ckpt, weights_only=True)
        assert written['state']['epoch'] == 1
        report = {}
        read = jconvert.variables_from_torch(
            jax_template(variant, in_ch, inputs),
            jconvert.load_torch_file(ckpt)['model'], report=report)
        assert report['missing'] == [] and report['unused'] == set()
        for k, v in jconvert.variables_to_torch_state(read).items():
            np.testing.assert_array_equal(v, written['model'][k].numpy(),
                                          err_msg=k)


def test_cli_fusion_teacher_with_augmentations(ntu, tmp_path, capsys):
    """The depth CLI takes -colour -eraser -occluder -occ_path: a fusion
    teacher epoch whose colour stream pastes occluders ('occluded') and
    runs the chain, with finite losses; the test epoch is unaugmented."""
    occ = jsynthetic.make_occluder_bank(str(tmp_path / 'occ'))
    run = depth_main.main(
        ntu_flags(ntu.meta, str(tmp_path / 'save'), ntu.model_path, 'aug')
        + ['-do_fusion', '-save_record', '-colour', '-eraser', '-occluder',
           '-occ_path', occ, '-occ_count', '4'])
    assert len(spec_lines(capsys.readouterr().out)) == 1
    assert all(np.isfinite(v) for v in run.train[0].values())
    assert dict(run.train_loader.impl_counts) == {'occluded': 2}
    assert run.test_loader._occ_bank is None
    assert 'occluded' not in run.test_loader.impl_counts


def test_cli_semi_teach(ntu, tmp_path, capsys):
    """-semi_teach on an NTU+PKU metadata file: the PKU train loader of the
    same metadata at -semi_batch feeds a semi batch into every distillation
    step."""
    pku = jsynthetic.make_pku_fixture(str(tmp_path / 'pku'), num_train=4,
                                      num_valid=2)
    with open(ntu.meta) as f:
        meta = json.load(f)
    with open(pku) as f:
        for k, v in json.load(f).items():
            meta[k].update(v)
    both = str(tmp_path / 'metadata.json')
    with open(both, 'w') as f:
        json.dump(meta, f)
    teacher = PoseResNet(block='basic', layers=(2, 2, 2, 2),
                         variant='depth', in_channels=3, stride=STRIDE,
                         num_joints=17, depth=D)
    teacher_ckpt = str(tmp_path / 'teacher.pth')
    torch.save({'state': {'epoch': 1}, 'model': teacher.state_dict()},
               teacher_ckpt)
    capsys.readouterr()
    run = depth_main.main(ntu_flags(both, str(tmp_path / 'save'),
                                    ntu.model_path, 'semi')
                          + ['-do_teach', '-semi_teach', '-semi_batch', '2',
                             '-teacher_path', teacher_ckpt, '-save_record'])
    text = capsys.readouterr().out
    assert text.count(' Semi Loss ') == 2
    semi = run.trainer.semi_loader
    assert isinstance(semi, loader.DepthPoseLoader)
    assert (semi.args.data_name, semi.batch_size, semi.enhance_thresh) == (
        'pku', 2, 0.5)
    assert np.isfinite(run.train[0]['dist_train_loss'])


@pytest.mark.parametrize('flag', ['-n_cudas 2', '-mesh_spatial 2',
                                  '-dist_coord h:1'])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match='ROADMAP Queue 1 item'):
        depth_main.main(['-model', 'resnet18', '-suffix', 's', '-data_name',
                         'ntu', '-save_path', 'p', '-criterion', 'SmoothL1',
                         '-n_cudas', '1'] + flag.split())


@pytest.mark.parametrize('flag', ['-save_every 5', '-save_state',
                                  '-trace_dir t'])
def test_ported_flags_pass_and_parse_as_the_root_parser(flag):
    """depth_main's -save_every, -save_state and -trace_dir pass
    check_ported and parse to the root parser's namespace (ntu_train.sh's
    flags)."""
    argv = ['-model', 'resnet18', '-suffix', 's', '-data_name', 'ntu',
            '-save_path', 'p', '-criterion', 'SmoothL1', '-n_cudas', '1',
            '-do_fusion', '-half_acc'] + flag.split()
    args = opts.parse(argv)
    check_ported(args)
    assert vars(args) == vars(root_opts.parse(argv))


@pytest.mark.parametrize('flags', [('-resume', '-pretrain'),
                                   ('-do_fusion', '-depth_only'),
                                   ('-depth_host', '-depth_only')])
def test_exclusive_flags_raise(flags):
    with pytest.raises(ValueError, match='exclude each other'):
        depth_main.main(['-model', 'resnet18', '-suffix', 's', '-data_name',
                         'ntu', '-save_path', 'p', '-criterion', 'SmoothL1',
                         '-n_cudas', '0', *flags])


def test_loader_names_map_to_the_ports_factories(tmp_path):
    """metadata.json's loader module names select the port's factories;
    an unknown name raises instead of importing a module."""
    path = str(tmp_path / 'metadata.json')
    for name, factory in (('depth_datasets', loader.depth_data_loader),
                          ('datasets', loader.data_loader)):
        with open(path, 'w') as f:
            json.dump({'loader': {'ntu': name}}, f)
        args = types.SimpleNamespace(metadata_path=path, data_name='ntu')
        assert depth_main.get_loader(args) is factory
    with open(path, 'w') as f:
        json.dump({'loader': {'ntu': 'os'}}, f)
    with pytest.raises(ValueError, match="'os'"):
        depth_main.get_loader(args)


def test_model_variant_is_the_references():
    args = types.SimpleNamespace(do_fusion=False, partial_conv=False)
    got = []
    for fusion in (False, True):
        for partial in (False, True):
            args.do_fusion, args.partial_conv = fusion, partial
            got.append(depth_main.model_variant(args))
    assert got == ['depth', 'partial_depth', 'fusion', 'partial_fusion']
