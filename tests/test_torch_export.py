"""pose_tpu_torch's deployment artifacts on the CPU, at test_torch_serve's
small size (resnet18, side 65, stride 32, 4 bins, 5 joints) with the same
numpy-drawn weights through state_dict_from_jax:

- the stem and int8 ops of `ops/library.py` pass torch.library.opcheck
  through their CPU implementations (the plain versions);
- `Predictor.export_artifact` -> `ArtifactPredictor` equals the eager
  Predictor bit for bit, for rgb f32, rgb half_acc, fusion (two streams)
  and a quantized rgb Predictor, and matches JAX's ArtifactPredictor on
  JAX's .jaxexport of the same weights;
- ragged and oversized batches, BatchingServer over an artifact, a
  process that imports only torch and the ops library;
- the predict CLI on a .pt2 against the port's checkpoint run and JAX's
  CLI on the .jaxexport, and its checks of the artifact against the flags.

Each artifact is exported once per module."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import predict as jpredict
from pose_tpu import serve as jserve

from pose_tpu_torch import predict, serve
from pose_tpu_torch.models.convert import state_dict_from_jax
from pose_tpu_torch.ops import int8_conv, library, stem

from tests.test_torch_predict import PEOPLE, TOL as CLI_TOL
from tests.test_torch_serve import (REPO, TOL, VARIANT_TOL, crops,
                                    jax_predictor, predictors, small_args,
                                    variant_inputs)

B = 4


def quantized_predictors():
    """A JAX and a port rgb Predictor (f32) quantized with the same scales:
    the port's calibration on two batches, handed to JAX's
    quantize_with_scales."""
    jp, tp = predictors(False, batch_size=B)
    scales = tp.quantize([crops(11, B), crops(12, B)])
    jp.quantize_with_scales(scales)
    return jp, tp


def fusion_predictors():
    args = small_args(joint_space=False)
    jp = jax_predictor(args, 'fusion', batch_size=B)
    tp = serve.Predictor(args, 'fusion', state_dict_from_jax(jp.variables),
                         batch_size=B, device='cpu')
    return jp, tp


# case -> (the two Predictors, inputs, the bound against JAX's artifact)
CASES = {
    'rgb_f32': (lambda: predictors(False, batch_size=B),
                lambda: (crops(1),), TOL[False]),
    'rgb_half_acc': (lambda: predictors(True, batch_size=B),
                     lambda: (crops(2),), TOL[True]),
    'fusion': (fusion_predictors,
               lambda: variant_inputs('fusion', False, 3),
               dict(relat_cam=VARIANT_TOL)),
    # int8 codes of inputs that differ by the f32 roundoff above may land
    # on the two sides of a rounding boundary, and the random-init decode
    # moves with them (test_torch_predict's INT8_TOL argument): bounded by
    # the half_acc tolerances
    'quant_rgb': (quantized_predictors, lambda: (crops(4),), TOL[True]),
}


@pytest.fixture(scope='module')
def exported(tmp_path_factory):
    """{case: (JAX Predictor, port Predictor, .pt2 path, .jaxexport
    path, the .pt2's ArtifactPredictor on the CPU)}, each exported and
    loaded once."""
    root = tmp_path_factory.mktemp('export')
    out = {}
    for case, (make, _, _) in CASES.items():
        jp, tp = make()
        path = tp.export_artifact(str(root / f'{case}.pt2'))
        out[case] = (jp, tp, path,
                     jp.export_artifact(str(root / f'{case}.jaxexport')),
                     serve.ArtifactPredictor(path, device='cpu'))
    return out


# ------------------------------------------------------------------- the ops


def stem_operands(seed, cin, b=2, side=9):
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(b, cin, side, side)).to(torch.bfloat16)
    w = torch.as_tensor(rng.randn(7, 7, cin, 64) * 0.1).to(torch.bfloat16)
    return x, w, stem.pack_weight(w)


def quant_operands(seed, dtype, with_bias, cin=8, cout=16):
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(2, cin, 7, 7)).to(dtype)
    wq = torch.as_tensor(rng.randint(-127, 128, (cout, cin, 3, 3)),
                         dtype=torch.int8)
    geom = int8_conv.Geometry(cout, cin, (3, 3), (2, 2), (1, 1), (1, 1))
    scale = torch.as_tensor(rng.rand(cout, 1, 1) * 1e-3, dtype=torch.float32)
    bias = (torch.as_tensor(rng.randn(cout, 1, 1)).to(dtype) if with_bias
            else None)
    return (x, int8_conv.pack_weight(wq), library.geometry_ints(geom),
            torch.tensor(0.02), scale, bias)


@pytest.mark.parametrize('cin,out_dtype', [(1, torch.bfloat16),
                                           (3, torch.float32),
                                           (4, torch.bfloat16)],
                         ids=['cin1_bf16', 'cin3_f32', 'cin4_bf16'])
def test_stem_op_passes_opcheck(cin, out_dtype):
    """The op's schema, fake function (shape, dtype, the channels_last
    strides of the real op) and tracing, on its CPU implementation; its
    output is the wrapper's NHWC result as the NCHW view."""
    x, w, packed = stem_operands(cin, cin)
    torch.library.opcheck(library.stem_conv_op, (x, w, packed, out_dtype))
    got = library.stem_conv_op(x, w, packed, out_dtype)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, stem.stem_conv(x, w, out_dtype).permute(
        0, 3, 1, 2))


@pytest.mark.parametrize('dtype,with_bias,acc_bf16', [
    (torch.float32, False, False), (torch.bfloat16, True, False),
    (torch.float32, True, True)], ids=['f32', 'bf16_bias', 'f32_bias_accbf16'])
def test_quantized_conv_op_passes_opcheck(dtype, with_bias, acc_bf16):
    """The same for the quantized conv op: its output is
    quantized_conv_plain's, bit for bit, in x's dtype and channels_last."""
    args = quant_operands(7, dtype, with_bias)
    torch.library.opcheck(library.quantized_conv_op, args + (acc_bf16,))
    got = library.quantized_conv_op(*args, acc_bf16)
    x, w, geom, x_scale, scale, bias = args
    want = int8_conv.quantized_conv_plain(
        x, w, library._geometry(geom), x_scale, scale, bias,
        torch.bfloat16 if acc_bf16 else torch.int32)
    assert got.dtype == dtype and got.stride() == want.stride()
    assert torch.equal(got, want)


# ------------------------------------------------------------- the artifacts


@pytest.mark.parametrize('case', list(CASES))
def test_artifact_equals_eager_predictor(exported, case):
    """The loaded artifact answers as the eager Predictor it came from, bit
    for bit (the same ops on the same weights, the decode included)."""
    _, tp, _, _, art = exported[case]
    assert art.batch_size == B and art.variables is None
    x = CASES[case][1]()
    got, want = art.predict_crops(*x), tp.predict_crops(*x)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        assert np.all(np.isfinite(got[k]))
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize('case', list(CASES))
def test_artifact_matches_jax_artifact(exported, case):
    """The port's artifact against JAX's ArtifactPredictor on JAX's
    .jaxexport of the same weights, within test_torch_serve's bounds."""
    _, _, _, jpath, art = exported[case]
    jart = jserve.ArtifactPredictor(jpath)
    assert art.in_shapes == jart.in_shapes
    assert art.out_shapes == jart.out_shapes
    x = CASES[case][1]()
    got, ref = art.predict_crops(*x), jart.predict_crops(*x)
    assert set(got) == set(ref)
    tol = CASES[case][2]
    for k in got:
        err = float(np.abs(got[k] - ref[k]).max())
        print(f'{case} {k}: {err:.3g}')
        assert err <= tol[k], (k, err)


def test_ragged_and_oversized_batches(exported):
    """A ragged batch is edge-padded to the baked size and sliced back;
    one above it raises JAX's ValueError."""
    _, tp, _, jpath, art = exported['rgb_f32']
    x = crops(5, B - 1)
    got = art.predict_crops(x)
    assert got['relat_cam'].shape == (B - 1, 5, 3)
    want = tp.predict_crops(x)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    big = crops(6, B + 1)
    with pytest.raises(ValueError) as err:
        art.predict_crops(big)
    with pytest.raises(ValueError) as jerr:
        jserve.ArtifactPredictor(jpath).predict_crops(big)
    assert str(err.value) == str(jerr.value)


def test_batching_server_over_artifact(exported):
    _, tp, _, _, art = exported['rgb_f32']
    x = crops(7, 6)
    ref = tp.predict_crops(x[:3]), tp.predict_crops(x[3:])
    with serve.BatchingServer(art, max_delay_ms=200.0) as server:
        out = [f.result(timeout=60) for f in [server.submit(c) for c in x]]
    assert server.served == 6
    for i, o in enumerate(out):
        for k in ('relat_cam', 'spec_mat'):
            # test_torch_serve's bound: batch position and padding rows
            # enter a sample's result only as f32 roundoff
            np.testing.assert_allclose(o[k], ref[i // 3][k][i % 3],
                                       atol=1e-4)


def test_artifact_refuses_a_mesh_and_another_device(exported):
    path = exported['rgb_f32'][2]
    with pytest.raises(NotImplementedError, match='Queue 1 item 4'):
        serve.ArtifactPredictor(path, device='cpu', mesh=object())
    with pytest.raises(ValueError, match='exported on cpu'):
        serve.ArtifactPredictor(path, device='meta')


def test_loads_with_only_the_ops_library(exported, tmp_path):
    """A process that imports torch and pose_tpu_torch.ops.library alone
    loads the quantized artifact and answers as the eager Predictor; the
    model code is never imported."""
    _, tp, path, _, _ = exported['quant_rgb']
    x = crops(8, B)
    np.save(tmp_path / 'x.npy', x)
    code = (
        'import sys\n'
        'import numpy as np, torch\n'
        'import pose_tpu_torch.ops.library as library\n'
        f'fn = library.load_artifact({path!r})\n'
        f'x = torch.from_numpy(np.load({str(tmp_path / "x.npy")!r}))\n'
        'with torch.inference_mode():\n'
        '    out = fn(x)\n'
        'for k, v in out.items():\n'
        f'    np.save({str(tmp_path)!r} + f"/{{k}}.npy", v.numpy())\n'
        'bad = sorted(m for m in sys.modules if m.startswith(\n'
        '    ("pose_tpu_torch.models", "pose_tpu_torch.serve",\n'
        '     "pose_tpu_torch.quant", "pose_tpu.", "jax")))\n'
        'assert not bad, bad\n'
        'print(sorted(out))\n')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "['relat_cam', 'spec_mat']"
    want = tp.predict_crops(x)
    for k in want:
        np.testing.assert_array_equal(np.load(tmp_path / f'{k}.npy'),
                                      want[k])


# ------------------------------------------------------------------ the CLI


@pytest.fixture(scope='module')
def cli_files(exported, tmp_path_factory):
    """Three 80x96 JPEG frames and 16-bit depth PNGs, test_torch_predict's
    person boxes (5 samples), and the rgb_f32 case's weights as a
    checkpoint."""
    from PIL import Image

    from tests.test_torch_model import jax_variables

    root = tmp_path_factory.mktemp('export_cli')
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (80, 96, 3), dtype=np.uint8)
                        ).save(root / f'frame_{i}.jpg')
        Image.fromarray(rng.randint(800, 5000, (80, 96), dtype=np.uint16)
                        ).save(root / f'depth_{i}.png')
    with open(root / 'people.json', 'w') as f:
        json.dump(PEOPLE, f)
    torch.save({'model': state_dict_from_jax(jax_variables('resnet18')[1])},
               str(root / 'model_1.pth'))
    return root


def cli_argv(root, model_path, drop=(), **over):
    """The CLI's argv for the rgb_f32 artifact's model (5 joints, 3
    channels, joint_space) on the fixture's frames: `over` replaces or adds
    flags (None: a switch), `drop` removes them."""
    flags = dict(model='resnet18', side_in='65', stride='32', depth='4',
                 num_joints='5', batch_size=str(B),
                 images=str(root / 'frame_*.jpg'),
                 bboxes=str(root / 'people.json'), model_path=model_path,
                 out=str(root / 'out.json'), joint_space=None,
                 track_ids=None)
    flags.update(over)
    return [a for k, v in flags.items() if k not in drop
            for a in ((f'-{k}',) if v is None else (f'-{k}', v))]


def test_predict_cli_serves_pt2(exported, cli_files):
    """-model_path x.pt2: the records equal the port's run on the
    checkpoint, and match JAX's CLI on its .jaxexport within
    test_torch_predict's bounds."""
    _, _, pt2, jaxexport, _ = exported['rgb_f32']
    got = predict.main(cli_argv(cli_files, pt2), device='cpu')
    with open(cli_files / 'out.json') as f:
        assert json.load(f) == json.loads(json.dumps(got))
    want = predict.main(cli_argv(cli_files, str(cli_files / 'model_1.pth')),
                        device='cpu')
    ref = jpredict.main(cli_argv(cli_files, jaxexport))
    assert len(got['frames']) == sum(len(v) for v in PEOPLE.values())
    assert got == dict(want, model_path=pt2)
    for rec, jrec in zip(got['frames'], ref['frames']):
        assert set(rec) == set(jrec)
        for k in ('key', 'person', 'bbox', 'track_id'):
            assert rec[k] == jrec[k], k
        for k, tol in CLI_TOL.items():
            np.testing.assert_allclose(rec[k], jrec[k], atol=tol)


# flags against the rgb_f32 artifact's shapes (side 65, 3 channels, 5
# joints, one stream) -> JAX's SystemExit on its .jaxexport, word for word;
# -quantize in the port's wording
MISMATCH = {
    'side_in': dict(side_in='129'),
    'channels': dict(extra_channel=None),
    'joints': dict(num_joints='17'),
    'streams': dict(drop=('joint_space', 'bboxes'), do_fusion=None),
    'quantize': dict(quantize=None),
}


@pytest.mark.parametrize('case', list(MISMATCH))
def test_predict_cli_checks_the_artifact(exported, cli_files, case):
    _, _, pt2, jaxexport, _ = exported['rgb_f32']
    over = dict(MISMATCH[case])
    if case == 'streams':
        over['depth_images'] = str(cli_files / 'depth_*.png')
    with pytest.raises(SystemExit) as err:
        predict.main(cli_argv(cli_files, pt2, **over), device='cpu')
    with pytest.raises(SystemExit) as jerr:
        jpredict.main(cli_argv(cli_files, jaxexport, **over))
    if case == 'quantize':
        assert 'a .pt2 artifact bakes its precision' in str(err.value)
        assert 'bakes its precision' in str(jerr.value)
    else:
        assert str(err.value) == str(jerr.value) and str(err.value)
