"""The port's inference CLI (pose_tpu_torch/predict.py) against the root
predict.py on the CPU, at tests/test_predict.py's small size (resnet18,
side 65, stride 32, 4 bins, 19 joints) on 80x96 JPEG frames and 16-bit
depth PNGs, with rgb, depth and fusion checkpoints that JAX wrote (numpy
weights through pose_tpu's save_torch_file).

One module fixture runs JAX's predict.main once per configuration and the
port's predict.main(argv, device='cpu') on the same argv:
  (a) rgb -joint_space -extra_channel, multi-person -bboxes, a distorted
      -camera (the general lookup), -track_ids, -viz;
  (b) (a) with -quantize -calib_batches 2 -batch_size 2: batch 1 serves
      the float forward, batch 2 calibrates and is the first int8 batch;
  (c) -depth_only -nexponent -to_depth (the depth student);
  (d) -do_fusion (both streams).
Also JAX's flag validation with the same SystemExit text, -video, the
best.pth pointer, the part not ported yet (-mesh), the refused .jaxexport
and a served .pt2."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

import predict as jpredict
from pose_tpu.models.convert import save_torch_file, variables_to_torch_state

from pose_tpu_torch import predict, serve

from tests.test_torch_serve import REPO, jax_predictor

MODEL = ['-model', 'resnet18', '-side_in', '65', '-stride', '32', '-depth',
         '4', '-num_joints', '19']
PEOPLE = {'frame_0.jpg': [[5, 5, 40, 60], [45, 10, 45, 60]],
          'frame_1.jpg': [[10, 8, 70, 60]],
          'frame_2.jpg': [[0, 0, 96, 80], [20, 10, 50, 60]]}
CAMERA = dict(K=[[120.0, 0, 48], [0, 120.0, 40], [0, 0, 1]],
              dist=[-0.2, 0.05, 0.0, 0.0, 0.0])
# f32, the same weights and frames: the warps and XLA:CPU's convs sum in
# another order than the port's. Measured on the CPU at most 5.9e-4 mm
# (relat_cam), 1.1e-5 px (spec_mat), 3.8e-3 mm (absolute_cam and _world,
# after the root solve) and 1.8e-4 px (image_coord); bounds about 5x. An
# int8 batch of (b) quantizes conv inputs that differ by that roundoff,
# and a code that lands on the other side of a rounding boundary moves
# the random-init decode (near-uniform logits, test_quant.py's most
# sensitive regime): measured 1.15 mm, 0.064 px, 4.27 mm and 0.41 px
# there; bounds about 5x on the 2D values, and 10 / 20 mm on the 3D ones
# (test_quant.py's 1 % of the 1000 mm range, twice that after the root
# solve).
TOL = dict(relat_cam=3e-3, spec_mat=6e-5, absolute_cam=0.02,
           absolute_world=0.02, image_coord=1e-3)
INT8_TOL = dict(relat_cam=10.0, spec_mat=0.35, absolute_cam=20.0,
                absolute_world=20.0, image_coord=2.0)


@pytest.fixture(scope='module')
def fx(tmp_path_factory):
    """Frames, depth PNGs, box and camera files, and JAX-written rgb,
    depth and fusion checkpoints."""
    from PIL import Image

    root = tmp_path_factory.mktemp('predict_port')
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (80, 96, 3), dtype=np.uint8)
                        ).save(root / f'frame_{i}.jpg')
        Image.fromarray(rng.randint(800, 5000, (80, 96), dtype=np.uint16)
                        ).save(root / f'depth_{i}.png')
    for name, obj in (('people.json', PEOPLE), ('camera.json', CAMERA),
                      ('depth_cam.json', dict(K=[[110.0, 0, 48],
                                                 [0, 110.0, 40],
                                                 [0, 0, 1]]))):
        with open(root / name, 'w') as f:
            json.dump(obj, f)

    def save(variant, name, **over):
        args = serve.default_args(model='resnet18', side_in=65, stride=32,
                                  depth=4, num_joints=19, half_acc=False,
                                  **over)
        p = jax_predictor(args, variant, batch_size=1,
                          seed=len(name))
        save_torch_file(dict(state={}, model=variables_to_torch_state(
            jax.device_get(p.variables))), str(root / name))

    save('rgb', 'model_rgb.pth', joint_space=True, extra_channel=True)
    save('depth', 'model_depth.pth', joint_space=False, depth_only=True)
    save('fusion', 'model_fusion.pth', joint_space=False)
    return root


def config_argv(fx, name):
    rgb = MODEL + ['-model_path', str(fx / 'model_rgb.pth'), '-joint_space',
                   '-extra_channel', '-images', str(fx / 'frame_*.jpg'),
                   '-bboxes', str(fx / 'people.json'), '-camera',
                   str(fx / 'camera.json'), '-track_ids']
    return {
        'a': rgb,
        'b': rgb + ['-quantize', '-calib_batches', '2', '-batch_size', '2'],
        'c': MODEL + ['-model_path', str(fx / 'model_depth.pth'),
                      '-depth_only', '-nexponent', '-to_depth',
                      '-depth_images', str(fx / 'depth_*.png'),
                      '-depth_camera', str(fx / 'depth_cam.json')],
        'd': MODEL + ['-model_path', str(fx / 'model_fusion.pth'),
                      '-do_fusion', '-images', str(fx / 'frame_*.jpg'),
                      '-depth_images', str(fx / 'depth_*.png')],
    }[name]


@pytest.fixture(scope='module')
def runs(fx):
    """{config: (JAX blob, port blob)}, each CLI run once."""
    out = {}
    for name in 'abcd':
        argv = config_argv(fx, name)
        viz = ['-viz', str(fx / f'viz_{name}_%s')] if name == 'a' else []
        jblob = jpredict.main(argv + ['-out', str(fx / f'{name}_jax.json')]
                              + [v.replace('%s', 'jax') for v in viz])
        tblob = predict.main(argv + ['-out', str(fx / f'{name}_port.json')]
                             + [v.replace('%s', 'port') for v in viz],
                             device='cpu')
        out[name] = (jblob, tblob)
    return out


@pytest.mark.parametrize('name', list('abcd'))
def test_records_match_jax(fx, runs, name):
    jblob, tblob = runs[name]
    with open(fx / f'{name}_port.json') as f:
        assert json.load(f) == json.loads(json.dumps(tblob))
    assert {k: v for k, v in tblob.items() if k != 'frames'} == {
        k: v for k, v in jblob.items() if k != 'frames'}
    assert len(tblob['frames']) == len(jblob['frames']) > 0
    worst = {}
    for i, (ref, got) in enumerate(zip(jblob['frames'], tblob['frames'])):
        assert set(got) == set(ref)
        for k in ('key', 'person', 'bbox', 'track_id'):
            assert got.get(k) == ref.get(k), (i, k)
        # (b): 5 samples at batch 2; batch 1 (samples 0, 1) is the float
        # forward, the others int8
        tol = INT8_TOL if name == 'b' and i >= 2 else TOL
        for k in tol:
            if k in ref:
                d = float(np.max(np.abs(np.asarray(got[k])
                                        - np.asarray(ref[k]))))
                assert np.all(np.isfinite(got[k])) and d <= tol[k], (i, k, d)
                worst[k] = max(worst.get(k, 0.0), d)
    print(f'({name}) worst', worst)
    if name in 'ab':
        assert [r['person'] for r in tblob['frames']] == [0, 1, 0, 0, 1]
        assert len({r['track_id'] for r in tblob['frames']}) >= 2
    if name == 'a':
        assert sorted(os.listdir(fx / 'viz_a_port')) == sorted(
            os.listdir(fx / 'viz_a_jax')) == [
                'frame_0.png', 'frame_0_p1.png', 'frame_1.png',
                'frame_2.png', 'frame_2_p1.png']
    if name == 'c':
        assert tblob['variant'] == 'depth'
        assert 'spec_mat' not in tblob['frames'][0]
    if name == 'd':
        assert tblob['variant'] == 'fusion'


def test_calib_batches_window(runs):
    """(b) against (a): the batch inside the calibration window is the
    float forward (equal to (a)'s up to the float forward's batch-size
    roundoff), the later batches int8 (different)."""
    float_run, int8_run = runs['a'][1], runs['b'][1]
    for i, (ref, got) in enumerate(zip(float_run['frames'],
                                       int8_run['frames'])):
        d = np.max(np.abs(np.asarray(got['relat_cam'])
                          - np.asarray(ref['relat_cam'])))
        if i < 2:
            assert d <= 1e-3, (i, d)
        else:
            assert 0 < d < 20.0, (i, d)


# JAX's flag validation (tests/test_predict.py, test_input_validation and
# test_box_list_longer_than_stream): argv after -model_path
VALIDATION = {
    'no_stream': [],
    'no_match': ['-images', '{fx}/nomatch_*.jpg'],
    'depth_joint_space': ['-depth_only', '-joint_space', '-depth_images',
                          '{fx}/depth_*.png'],
    'fusion_needs_depth': ['-do_fusion', '-images', '{fx}/frame_*.jpg'],
    'fusion_extra_channel': ['-do_fusion', '-extra_channel', '-images',
                             '{fx}/frame_*.jpg', '-depth_images',
                             '{fx}/depth_*.png'],
    'depth_only_bboxes': ['-depth_only', '-bboxes', 'b.json',
                          '-depth_images', '{fx}/depth_*.png'],
    'nexponent_rgb': ['-nexponent', '-images', '{fx}/frame_*.jpg'],
    'fusion_depth_only': ['-do_fusion', '-depth_only', '-depth_images',
                          '{fx}/depth_*.png'],
    'boxes_too_long': ['-images', '{fx}/frame_*.jpg', '-bboxes',
                       '{fx}/toolong.json'],
    'viz_needs_joint_space': ['-images', '{fx}/frame_*.jpg', '-viz', 'v'],
}


@pytest.mark.parametrize('case', list(VALIDATION))
def test_validation_matches_jax(fx, case):
    with open(fx / 'toolong.json', 'w') as f:
        json.dump([[0, 0, 9, 9]] * 5, f)          # 5 entries, 3 frames
    argv = ['-model_path', 'x.pth'] + [a.format(fx=fx)
                                       for a in VALIDATION[case]]
    with pytest.raises(SystemExit) as jerr:
        jpredict.main(argv)
    with pytest.raises(SystemExit) as terr:
        predict.main(argv, device='cpu')
    assert str(terr.value) == str(jerr.value) and str(terr.value)


def test_all_empty_boxes_yield_no_samples(fx, tmp_path):
    """A frame's [] is zero detections; an all-empty spec fails with JAX's
    message."""
    with open(tmp_path / 'empty.json', 'w') as f:
        json.dump({f'frame_{i}.jpg': [] for i in range(3)}, f)
    with pytest.raises(SystemExit, match='no person samples'):
        predict.main(MODEL + ['-model_path', str(fx / 'model_rgb.pth'),
                              '-joint_space', '-extra_channel', '-images',
                              str(fx / 'frame_*.jpg'), '-bboxes',
                              str(tmp_path / 'empty.json'), '-out',
                              str(tmp_path / 'o.json')], device='cpu')


def test_variant_dispatch_and_cameras(tmp_path):
    parse = lambda extra: predict.build_parser().parse_args(
        ['-model_path', 'x.pth'] + extra)
    for extra in ([], ['-depth_only'], ['-depth_net'], ['-do_fusion'],
                  ['-partial_conv', '-depth_only'],
                  ['-partial_conv', '-do_fusion']):
        assert predict.resolve_variant(parse(extra)) == \
            jpredict.resolve_variant(jpredict.build_parser().parse_args(
                ['-model_path', 'x.pth'] + extra))
    with open(tmp_path / 'cam.json', 'w') as f:
        json.dump(dict(K=[[100.0, 0, 8], [0, 100.0, 8], [0, 0, 1]],
                       dist=[0, 0, 0, 0, 0]), f)
    cam = predict.load_camera(str(tmp_path / 'cam.json'), (16, 16))
    assert cam.distortion_coeffs is None         # all-zero is a pinhole


def test_best_pth_pointer(tmp_path):
    save_torch_file({'best': 7}, str(tmp_path / 'best.pth'))
    assert predict.resolve_model_path(str(tmp_path / 'best.pth')) == str(
        tmp_path / 'model_7.pth')
    assert predict.resolve_model_path('foo/model_3.pth') == 'foo/model_3.pth'


def test_video_streams_in_chunks(fx):
    """-video: a clip written with cv2 drives the same path through
    tools/video.prefetch, lazily, in batch_size chunks (5 frames at batch
    2 = 3 chunks with a padded tail)."""
    cv2 = pytest.importorskip('cv2')
    path = str(fx / 'clip.avi')
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), 5.0,
                             (96, 80))
    if not writer.isOpened():
        pytest.skip('no MJPG encoder in this cv2 build')
    rng = np.random.RandomState(1)
    for _ in range(5):
        writer.write(rng.randint(0, 255, (80, 96, 3), dtype=np.uint8))
    writer.release()
    frames, total, canvas = predict.load_frames(
        types.SimpleNamespace(images=None, video=path))
    assert total is None and canvas is None
    assert next(frames)[0] == 'frame_000000'
    blob = predict.main(MODEL + ['-model_path', str(fx / 'model_rgb.pth'),
                                 '-joint_space', '-extra_channel',
                                 '-batch_size', '2', '-video', path, '-out',
                                 str(fx / 'video.json')], device='cpu')
    assert [r['key'] for r in blob['frames']] == [
        'frame_%06d' % i for i in range(5)]
    for rec in blob['frames']:
        assert np.all(np.isfinite(np.asarray(rec['absolute_cam'])))


def test_optional_dependency_names_its_flag(fx, monkeypatch):
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(SystemExit, match='-viz needs matplotlib'):
        predict.main(MODEL + ['-model_path', str(fx / 'model_rgb.pth'),
                              '-joint_space', '-images',
                              str(fx / 'frame_*.jpg'), '-viz', 'v'],
                     device='cpu')
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(SystemExit, match='-video needs cv2'):
        predict.load_frames(types.SimpleNamespace(images=None, video='c'))


@pytest.mark.parametrize('case', ['mesh', 'jaxexport', 'pt2'])
def test_unported_parts_raise(fx, case):
    """-mesh above 1 raises NotImplementedError naming its ROADMAP item; a
    JAX .jaxexport -model_path is refused with a SystemExit that points to
    the port's own artifacts; a .pt2 one (exported from the rgb
    checkpoint at the run's batch size) serves, its records equal to the
    checkpoint run's."""
    base = MODEL + ['-model_path', str(fx / 'model_rgb.pth'), '-images',
                    str(fx / 'frame_*.jpg')]
    if case == 'mesh':
        with pytest.raises(NotImplementedError,
                           match='ROADMAP Queue 1 item 4'):
            predict.main(base + ['-mesh', '2'], device='cpu')
    elif case == 'jaxexport':
        with pytest.raises(SystemExit, match=r'reads its own \.pt2 '
                           r'artifacts.*needs JAX.*export_artifact'):
            predict.main(base + ['-model_path', 'pose.jaxexport'],
                         device='cpu')
    else:
        rgb = base + ['-joint_space', '-extra_channel', '-out',
                      str(fx / 'unported_pt2.json')]
        pt2 = serve.Predictor.from_checkpoint(
            str(fx / 'model_rgb.pth'), serve.default_args(
                model='resnet18', side_in=65, stride=32, depth=4,
                num_joints=19, half_acc=False, joint_space=True,
                extra_channel=True), batch_size=3,
            device='cpu').export_artifact(str(fx / 'unported.pt2'))
        got = predict.main(rgb + ['-model_path', pt2], device='cpu')
        want = predict.main(rgb, device='cpu')
        assert len(got['frames']) == 3
        assert got == dict(want, model_path=pt2)


def test_cuda_by_default(fx):
    """Without a device the CLI runs on CUDA, and raises where there is
    none."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict.main(MODEL + ['-model_path', str(fx / 'model_rgb.pth'),
                              '-images', str(fx / 'frame_*.jpg')])


def test_inference_modules_import_no_jax():
    code = ('import sys\n'
            'import pose_tpu_torch.predict, pose_tpu_torch.quant\n'
            'import pose_tpu_torch.tools.tracking, pose_tpu_torch.tools.viz\n'
            'import pose_tpu_torch.tools.video, pose_tpu_torch.ops.int8_conv\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
            '             ("jax", "jaxlib", "flax", "pose_tpu", "predict",\n'
            '              "joint_settings", "datasets", "cv2",\n'
            '              "matplotlib", "scipy"))\n'
            'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=120)

