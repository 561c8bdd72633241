"""pose_tpu_torch on the card: the split-warp, fused-BN, banded-warp,
full-scanline-warp, partial-conv renorm, stem and int8 conv CUDA kernels
against their plain PyTorch versions, their wrappers' checks and launch
counts, the serving slice, a train step and a distillation step on the
card against the same on the CPU, the fused quantized conv against its
plain chain, and a quantized Predictor's forward against its plain int8
route on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX (the machine with the card has none), so it runs there on
its own, without the JAX-forcing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pose_tpu_torch import runtime, serve
from pose_tpu_torch.models import PoseResNet, init_weights
from pose_tpu_torch.ops import (colour, fused_bn, fused_bn_cuda,
                                partial_conv, stem, warp, warp_banded,
                                warp_cuda)
from pose_tpu_torch.train import default_depth_args, default_train_args, steps

pytestmark = pytest.mark.cuda

S, OUT = 128, 65
# kernel against plain version on the same card tensors: the same f32
# operations in the same order, the 2-term sums in another order than
# cuBLAS's; values in [0, 1]
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the split-warp kernel runs only on '
                    'the card')
    warp_cuda.build()
    return torch.device('cuda')


def frames(seed, u8=True, small_extents=False, b=3):
    """Canvases (zero-padded beyond smaller extents when asked) and crop
    homographies that pass the split gate."""
    rng = np.random.RandomState(seed)
    if u8:
        imgs = rng.randint(0, 256, (b, S, S, 3), dtype=np.uint8)
    else:
        imgs = rng.rand(b, S, S, 3).astype(np.float32)
    ext = np.full((b, 2), S, np.int32)
    if small_extents:
        ext = rng.randint(S * 3 // 4, S, (b, 2)).astype(np.int32)
        for i, (h, w) in enumerate(ext):
            imgs[i, h:] = 0
            imgs[i, :, w:] = 0
    homs = []
    for i in range(b):
        sc, th = 90.0 / OUT / rng.uniform(0.9, 1.1), rng.uniform(-.05, .05)
        homs.append([[sc * np.cos(th), -sc * np.sin(th), 4 + 3 * i],
                     [sc * np.sin(th), sc * np.cos(th), 6 + 2 * i],
                     [rng.uniform(-1, 1) * 2e-4, rng.uniform(-1, 1) * 2e-4,
                      1.0]])
    homs = np.asarray(homs, np.float32)
    assert warp.split_band_ok(homs, (OUT, OUT))
    return imgs, homs, ext


@pytest.mark.parametrize('wdtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('small_extents', [False, True],
                         ids=['full', 'extents'])
@pytest.mark.parametrize('u8', [True, False], ids=['uint8', 'float32'])
def test_kernel_matches_plain(dev, wdtype, small_extents, u8):
    imgs, homs, ext = frames(70 + 2 * u8 + small_extents, u8, small_extents)
    imgs, homs, ext = (torch.as_tensor(a).to(dev) for a in (imgs, homs, ext))
    wd = getattr(torch, wdtype)
    before = warp_cuda.split_warp.launches
    out = warp.warp_batch_split(imgs, homs, (OUT, OUT), ext, stage_b='cuda',
                                planar_out=True, wdtype=wd)
    ref = warp.warp_batch_split(imgs, homs, (OUT, OUT), ext, stage_b='mxu',
                                planar_out=True, wdtype=wd)
    torch.cuda.synchronize()
    assert warp_cuda.split_warp.launches == before + 1
    assert out.shape == (3, 3, OUT, OUT) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= TOL


def split_args(kind, small_extents, seed):
    """Split-warp arguments on the card: RGB uint8 canvases with bf16
    weights, RGB f32 with f32 weights, or raw depth (f32, C = 1)."""
    if kind == 'depth':
        imgs, homs, ext = depth_frames(seed)
        if not small_extents:
            ext = np.tile(np.array(imgs.shape[1:3], np.int32), (3, 1))
    else:
        imgs, homs, ext = frames(seed, kind == 'u8', small_extents)
    canv, homs, ext = (torch.as_tensor(a).cuda() for a in (imgs, homs, ext))
    m = warp.split_defaults((OUT, OUT))[0]
    residual, scale = warp.decompose_homography(homs, (OUT, OUT), m)
    post = 1 / 255 if kind == 'u8' else 1.0
    wdtype = torch.bfloat16 if kind == 'u8' else torch.float32
    return (canv, residual, scale, ext, (OUT, OUT), m, post, wdtype)


@pytest.mark.parametrize('small_extents', [False, True],
                         ids=['full', 'extents'])
@pytest.mark.parametrize('kind', ['u8', 'f32', 'depth'])
def test_staged_tiles_equal_direct_tiles(dev, kind, small_extents):
    """The kernel with its tiles' stage A staged in shared memory (the
    wrapper's budget) and with budget 0 (every tile from the canvas
    directly, as the first version computed it): the same expressions in the
    same order, so the same bits. The over-budget counter equals
    tile_footprints' prediction for both budgets (0 for the staged run)."""
    args = split_args(kind, small_extents, 75 + small_extents)
    canv, residual, scale, ext, out_hw, m, post, wdtype = args
    n_ch, elem = canv.shape[3], canv.element_size()
    warp_cuda.over_budget_tiles(dev, reset=True)
    staged = warp_cuda.split_warp(*args)
    over = warp_cuda.over_budget_tiles(dev, reset=True)
    direct = torch.empty_like(staged)
    warp_cuda.launch_direct(canv, warp_cuda.pack_scalars(residual, scale,
                                                         ext),
                            direct, m, post, wdtype)
    over0 = warp_cuda.over_budget_tiles(dev, reset=True)
    assert torch.equal(staged, direct)
    assert over == warp_cuda.over_budget_count(
        residual, scale, ext, out_hw, m, n_ch, elem) == 0
    tiles = -(-OUT // warp_cuda.TILE[0]) * -(-OUT // warp_cuda.TILE[1]) * 3
    assert over0 == warp_cuda.over_budget_count(
        residual, scale, ext, out_hw, m, n_ch, elem, budget=0) == tiles


def test_over_budget_tiles_match_plain(dev):
    """Whole 512^2 canvases squeezed into 65^2 crops: each tile's canvas
    rectangle is far over the budget, so the kernel computes those tiles
    from the canvas directly (counted, as predicted), within TOL of the
    plain version."""
    rng = np.random.RandomState(77)
    imgs = torch.as_tensor(rng.randint(0, 256, (2, 512, 512, 3),
                                       dtype=np.uint8)).cuda()
    sc = 511.0 / (OUT - 1)
    homs = torch.tensor([[[sc, 0, 0], [0, sc, 0], [0, 0, 1]]] * 2,
                        dtype=torch.float32).cuda()
    ext = torch.tensor([[512, 512], [500, 480]], dtype=torch.int32).cuda()
    m = warp.split_defaults((OUT, OUT))[0]
    residual, scale = warp.decompose_homography(homs, (OUT, OUT), m)
    args = (imgs, residual, scale, ext, (OUT, OUT), m, 1 / 255,
            torch.bfloat16)
    want = warp_cuda.over_budget_count(residual, scale, ext, (OUT, OUT), m,
                                       3, 1)
    warp_cuda.over_budget_tiles(dev, reset=True)
    out = warp_cuda.split_warp(*args)
    assert warp_cuda.over_budget_tiles(dev, reset=True) == want > 0
    ref = warp_cuda.split_warp_plain(*args)
    assert float((out - ref).abs().max()) <= TOL


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    imgs, homs, ext = frames(80)
    canv, homs, ext = (torch.as_tensor(a).to(dev) for a in (imgs, homs, ext))
    m = warp.split_defaults((OUT, OUT))[0]
    residual, scale = warp.decompose_homography(homs, (OUT, OUT), m)
    good = (canv, residual, scale, ext, (OUT, OUT), m, 1 / 255,
            torch.bfloat16)
    bad = {
        'float64 canvases': (canv.double(),) + good[1:],
        'non-contiguous canvases': (canv.transpose(1, 2),) + good[1:],
        'one channel': (canv[..., :1].contiguous(),) + good[1:],
        'five channels': (torch.cat([canv, canv[..., :2]], -1),) + good[1:],
        'residual shape': (canv, residual[:2]) + good[2:],
        'extents shape': good[:3] + (ext[:2],) + good[4:],
        'float16 weights': good[:7] + (torch.float16,),
        'residual on the CPU': (canv, residual.cpu()) + good[2:],
    }
    before = warp_cuda.split_warp.launches
    for name, args in bad.items():
        with pytest.raises(ValueError):
            warp_cuda.split_warp(*args)
    assert warp_cuda.split_warp.launches == before, 'a refused call counted'
    warp_cuda.split_warp(*good)
    torch.cuda.synchronize()
    assert warp_cuda.split_warp.launches == before + 1


def test_gated_split_on_card_matches_cpu_slice(dev):
    """The gated preprocessor on the card (kernel, bf16 weights, the card's
    default) against process_color_batch on the CPU with the plain version
    and the same bf16 weights; the residual and scale rows are the card's
    on both sides, through the wrapper, since bf16 hat weights turn a
    last-bit difference of a sample position into a 2^-8 step. Bound: the
    kernel's 1e-5 through the normalisation (/ 0.225)."""
    imgs, homs, ext = frames(81, small_extents=True)
    pre = serve.GatedPreprocessor(OUT, device=dev)
    before = warp_cuda.split_warp.launches
    crops = pre(imgs, homs, ext)
    torch.cuda.synchronize()
    assert (pre.split_batches, pre.mxu_batches) == (1, 0)
    assert warp_cuda.split_warp.launches == before + 1
    m = warp.split_defaults((OUT, OUT))[0]
    residual, scale = warp.decompose_homography(
        torch.as_tensor(homs).to(dev), (OUT, OUT), m)
    ref = warp_cuda.split_warp_plain(
        torch.as_tensor(imgs), residual.cpu(), scale.cpu(),
        torch.as_tensor(ext), (OUT, OUT), m, 1 / 255, torch.bfloat16)
    ref = colour.normalize_imagenet_planar(torch.clamp(ref, 0, 1))
    err = float((crops.cpu() - ref.permute(0, 2, 3, 1)).abs().max())
    assert err <= TOL / 0.225


def test_f32_predictor_on_card_matches_cpu(dev):
    """An f32 Predictor (cuDNN with TF32 off) against the same weights on
    the CPU: f32 convolutions summed in another order, on ~1000 mm values;
    bounds 0.05 mm, 0.005 px and 1 mm after the root solve."""
    args = serve.default_args(model='resnet18', side_in=OUT, stride=32,
                              depth=4, num_joints=5, half_acc=False)
    x = np.random.RandomState(82).randn(3, OUT, OUT, 3).astype(np.float32)
    intr = np.tile(np.array([[100., 0, 32], [0, 100., 32], [0, 0, 1]],
                            np.float32), (3, 1, 1))
    outs = {}
    for device in (dev, 'cpu'):
        pred = serve.Predictor(args, batch_size=4, device=device, seed=0)
        outs[str(device)] = (pred.predict_crops(x),
                             pred.predict_absolute(x, intr))
    (p_gpu, a_gpu), (p_cpu, a_cpu) = outs[str(dev)], outs['cpu']
    np.testing.assert_allclose(p_gpu['relat_cam'], p_cpu['relat_cam'],
                               atol=0.05)
    np.testing.assert_allclose(p_gpu['spec_mat'], p_cpu['spec_mat'],
                               atol=0.005)
    np.testing.assert_allclose(a_gpu, a_cpu, atol=1.0)


# ------------------------------------------------------------- fused BN

# the BN kernels' shapes: ragged row counts, the narrowest channel tiles
# (C = 8: one bf16 vector per row) and a wider multi-group one
BN_SHAPES = [(75, 256), (126, 64), (1000, 8), (2 * 33 * 33, 128)]


@pytest.fixture
def bn_dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the fused-BN kernels run only on '
                    'the card')
    fused_bn_cuda.build()
    return torch.device('cuda')


def bn_inputs(dev, m, c, dtype, seed):
    g = torch.Generator(device='cpu').manual_seed(seed)
    x = (torch.randn(m, c, generator=g) * 2 + 0.5).to(dev, dtype)
    res = torch.randn(m, c, generator=g).to(dev, dtype)
    dy = torch.randn(m, c, generator=g).to(dev, dtype)
    gamma = (torch.rand(c, generator=g) + 0.5).to(dev)
    beta = torch.randn(c, generator=g).to(dev)
    return x, res, dy, gamma, beta


def assert_ulp(got, ref):
    """Within one ulp of the output dtype: the kernel and the plain version
    compute the same f32 operations in the same order (bit for bit
    expected); one rounding of the cast may flip."""
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -23
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= ulp * ref.float().abs() + 1e-30).all()), \
        float(diff.max())


def assert_coef(got, ref):
    """(5, C) coefficients from the same sums by the same f32 formulas;
    rsqrtf and torch.rsqrt may differ by an ulp, which the cancellation in
    shift and c3 carries into an absolute error: within 1e-6 of each row's
    largest value."""
    bound = 1e-6 * ref.abs().amax(1, keepdim=True)
    assert bool(((got - ref).abs() <= bound).all()), \
        float((got - ref).abs().max())


def assert_sums(got, ref, abs_terms):
    """Channel sums in another order: within 1e-5 of the sum of the terms'
    magnitudes."""
    assert bool(((got - ref).abs() <= 1e-5 * abs_terms + 1e-30).all()), \
        float((got - ref).abs().max())


@pytest.mark.parametrize('m,c', BN_SHAPES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
@pytest.mark.parametrize('relu,has_res', [(False, False), (True, False),
                                          (False, True), (True, True)],
                         ids=['plain', 'relu', 'res', 'res_relu'])
def test_bn_kernels_match_plain(bn_dev, relu, has_res, dtype, m, c):
    x, res, dy, gamma, beta = bn_inputs(bn_dev, m, c, dtype, m + c)
    res = res if has_res else None
    before = {k: f.launches for k, f in fused_bn_cuda.KERNELS.items()}
    sums, coef = fused_bn_cuda.stats(x, gamma, beta, 1e-5)
    ref_sums = fused_bn.channel_sums_plain(x)
    xf = x.float()
    assert_sums(sums, ref_sums, torch.stack([xf.abs().sum(0),
                                             (xf * xf).sum(0)]))
    # the coefficient math on the kernel's own sums: the same f32 formulas
    assert_coef(coef, fused_bn.stats_coef(sums, m, gamma, beta, 1e-5))
    mean, _, rstd, scale, shift = coef
    y = fused_bn_cuda.apply(x, res, scale, shift, relu)
    assert_ulp(y, fused_bn.apply_plain(x, res, scale, shift, relu))
    ym = y if relu else None
    bsums, bcoef = fused_bn_cuda.bwd_sums(x, dy, ym, mean, rstd, gamma)
    dyf = fused_bn._masked_dy(dy, ym)
    assert_sums(bsums, fused_bn.bwd_sums_plain(x, dy, ym, mean),
                torch.stack([dyf.abs().sum(0),
                             (dyf * (xf - mean)).abs().sum(0)]))
    assert_coef(bcoef, fused_bn.bwd_coef(bsums, m, gamma, mean, rstd))
    a, c2, c3, _, _ = bcoef
    dx, dres = fused_bn_cuda.dx(x, dy, ym, a, c2, c3, has_res)
    ref_dx, ref_dres = fused_bn.dx_plain(x, dy, ym, a, c2, c3, has_res)
    torch.cuda.synchronize()
    assert_ulp(dx, ref_dx)
    if has_res:
        assert torch.equal(dres, ref_dres)
    else:
        assert dres is None
    after = {k: f.launches for k, f in fused_bn_cuda.KERNELS.items()}
    assert all(after[k] == before[k] + 1 for k in after), (before, after)


def test_bn_reductions_repeat_bit_for_bit(bn_dev):
    x, _, dy, gamma, beta = bn_inputs(bn_dev, 2 * 33 * 33, 128,
                                      torch.bfloat16, 5)
    runs = [fused_bn_cuda.stats(x, gamma, beta, 1e-5) for _ in range(3)]
    assert all(torch.equal(r[0], runs[0][0]) for r in runs)
    mean, rstd = runs[0][1][0], runs[0][1][2]
    back = [fused_bn_cuda.bwd_sums(x, dy, None, mean, rstd, gamma)
            for _ in range(3)]
    assert all(torch.equal(r[0], back[0][0]) for r in back)


def test_bn_function_on_card_matches_cpu(bn_dev):
    """fused_batch_norm forward and backward through the autograd function
    on the card (kernels) and on the CPU (plain versions), channels_last
    4-D bf16: within one bf16 ulp plus 2e-6 of the largest value (the sums
    in another order move the f32 values before the cast)."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(4, 64, 9, 11, generator=g).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    res = torch.randn(4, 64, 9, 11, generator=g).to(torch.bfloat16)
    res = res.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(4, 64, 9, 11, generator=g)
    gamma, beta = torch.rand(64, generator=g) + 0.5, torch.randn(64,
                                                                 generator=g)
    outs = {}
    for dev in (bn_dev, torch.device('cpu')):
        leaves = [t.to(dev).requires_grad_() for t in (x, res, gamma, beta)]
        y, mean, var = fused_bn.fused_batch_norm(
            leaves[0], leaves[2], leaves[3], leaves[1], 1e-5, True)
        (y.float() * dy.to(dev)).sum().backward()
        outs[dev.type] = [t.detach().float().cpu() for t in
                          [y, mean, var] + [t.grad for t in leaves]]
    for got, ref in zip(outs['cuda'], outs['cpu']):
        bound = 2e-6 * ref.abs().max() + 2.0 ** -7 * ref.abs()
        assert bool(((got - ref).abs() <= bound).all())


def test_bn_wrappers_refuse_what_the_kernels_do_not_take(bn_dev):
    x, res, dy, gamma, beta = bn_inputs(bn_dev, 64, 64, torch.bfloat16, 7)
    flat = torch.empty(64 * 64 + 1, dtype=torch.bfloat16, device=bn_dev)
    bad_x = {
        'on the CPU': x.cpu(),
        'float16': x.half(),
        'float64': x.double(),
        'C not a multiple of 8': x[:, :60].contiguous(),
        'not contiguous': x.t(),
        'misaligned': flat[1:].view(64, 64),
        'one dimension': x.reshape(-1),
    }
    before = {k: f.launches for k, f in fused_bn_cuda.KERNELS.items()}
    for name, bad in bad_x.items():
        with pytest.raises(ValueError):
            fused_bn_cuda.stats(bad, gamma, beta, 1e-5)
    sums, coef = fused_bn_cuda.stats(x, gamma, beta, 1e-5)
    with pytest.raises(ValueError):
        fused_bn_cuda.apply(x, res.float(), coef[3], coef[4], True)
    with pytest.raises(ValueError):
        fused_bn_cuda.apply(x, None, coef[3].half(), coef[4], True)
    with pytest.raises(ValueError):
        fused_bn_cuda.bwd_sums(x, dy[:32], None, coef[0], coef[2], gamma)
    with pytest.raises(ValueError):
        fused_bn_cuda.dx(x, dy, None, coef[0][:32], coef[1], coef[2], False)
    x4 = x.reshape(1, 8, 8, 64).permute(0, 3, 1, 2)     # channels_last
    with pytest.raises(ValueError, match='channels_last'):
        fused_bn.fused_batch_norm(x4.contiguous(), gamma, beta)
    torch.cuda.synchronize()
    after = {k: f.launches for k, f in fused_bn_cuda.KERNELS.items()}
    assert after == dict(before, fused_bn_stats=before['fused_bn_stats'] + 1)
    # the channels_last view is taken without a copy
    y, _, _ = fused_bn.fused_batch_norm(x4, gamma, beta)
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_bn_counts_dy_layout_copies(bn_dev):
    x = torch.randn(2, 64, 5, 5, device=bn_dev).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    gamma = torch.ones(64, device=bn_dev)
    beta = torch.zeros(64, device=bn_dev)
    before = fused_bn.dy_rows.copies
    y, _, _ = fused_bn.fused_batch_norm(x, gamma, beta, None, 1e-5, True)
    y.backward(torch.ones_like(y))                       # channels_last
    assert fused_bn.dy_rows.copies == before
    y, _, _ = fused_bn.fused_batch_norm(x, gamma, beta, None, 1e-5, True)
    y.backward(torch.ones(y.shape, device=bn_dev))       # contiguous NCHW
    assert fused_bn.dy_rows.copies == before + 1


def test_joint_track_step_on_card_matches_cpu(bn_dev):
    """Two joint+track steps of a small f32 model with bn_impl='pallas' on
    the card (kernels, cuDNN with TF32 off) and on the CPU (plain
    versions), from the same weights and batch, at the flagship learn
    rate. f32 convolutions and sums in another order: losses within 1e-4
    relative, running statistics within 1e-4 of their largest value,
    parameters within 2 * lr * steps (an Adam step moves an element by at
    most ~lr, and an element whose gradient is ~0 may move either way; the
    second step's statistics see that)."""
    args = default_train_args(model='resnet18', side_in=65, stride=32,
                              depth=4, num_joints=5, half_acc=False,
                              bn_impl='pallas', learn_rate=2e-5)
    rng = np.random.RandomState(8)
    batch = dict(
        image=rng.randn(2, 65, 65, 4).astype(np.float32),
        true_cam=(rng.uniform(-300, 300, (2, 5, 3)) + [0, 0, 3000]).astype(
            np.float32),
        true_mat=rng.uniform(5, 60, (2, 5, 2)).astype(np.float32),
        true_val=rng.rand(2, 5) > 0.2,
        intrinsics=np.tile(np.array([[500., 0, 32], [0, 500., 32],
                                     [0, 0, 1]], np.float32), (2, 1, 1)))
    results = {}
    for dev in (bn_dev, torch.device('cpu')):
        model = PoseResNet(block='basic', layers=(1, 1, 1, 1),
                           in_channels=4, stride=32, num_joints=5, depth=4,
                           joint_space=True, bn_impl='pallas')
        init_weights(model, torch.Generator().manual_seed(0))
        model.to(dev, memory_format=torch.channels_last)
        state = steps.init_state(model, args)
        step = steps.make_joint_train_step(args, 2, do_track=True)
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        outs = [step(state, tb, args.learn_rate) for _ in range(2)]
        results[dev.type] = (
            [{k: float(v) for k, v in o.items()} for o in outs],
            {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (l_gpu, s_gpu), (l_cpu, s_cpu) = results['cuda'], results['cpu']
    for a, b in zip(l_gpu, l_cpu):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (k, a[k], b[k])
    for k, v in s_cpu.items():
        if k.endswith(('running_mean', 'running_var')):
            assert float((s_gpu[k] - v).abs().max()) <= 1e-4 * float(
                v.abs().max()), k
        elif v.is_floating_point():
            assert float((s_gpu[k] - v).abs().max()) <= (
                2 * args.learn_rate * 2), k


# ---------------------------------------------------------- depth slice


@pytest.fixture
def depth_dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the kernels of the depth slice run '
                    'only on the card')
    warp_cuda.build()
    warp_banded.build()
    partial_conv.build()
    return torch.device('cuda')


def depth_frames(seed, b=3, h=106, w=128):
    """Raw-depth canvases (metres, ~10 % zero holes, smaller extents) and
    crop homographies that pass the split gate."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(0.5, 4.5, (b, h, w, 1))
    d[rng.rand(b, h, w, 1) < 0.1] = 0.0
    ext = np.stack([h - rng.randint(0, 12, b), w - rng.randint(0, 12, b)],
                   1).astype(np.int32)
    for i, (eh, ew) in enumerate(ext):
        d[i, eh:] = 0.0
        d[i, :, ew:] = 0.0
    homs = []
    for _ in range(b):
        sc, th = 1.2 / rng.uniform(0.9, 1.1), rng.uniform(-0.05, 0.05)
        homs.append([[sc * np.cos(th), -sc * np.sin(th), rng.uniform(2, 20)],
                     [sc * np.sin(th), sc * np.cos(th), rng.uniform(2, 20)],
                     [rng.uniform(-1, 1) * 2e-4, rng.uniform(-1, 1) * 2e-4,
                      1.0]])
    homs = np.asarray(homs, np.float32)
    assert warp.split_band_ok(homs, (OUT, OUT))
    return d.astype(np.float32), homs, ext


def canvas_homs(seed, b=3, side=96):
    """Whole-canvas homographies that band_ok_v2 admits at band 32."""
    rng = np.random.RandomState(seed)
    homs = []
    for _ in range(b):
        sc, th = side / OUT * rng.uniform(0.95, 1.0), rng.uniform(-.03, .03)
        p = rng.uniform(-1, 1) * 1e-4
        homs.append([[sc * np.cos(th), -sc * np.sin(th), rng.uniform(0, 3)],
                     [sc * np.sin(th), sc * np.cos(th), rng.uniform(0, 3)],
                     [p, -p, 1.0]])
    homs = np.asarray(homs, np.float32)
    assert warp_cuda.band_ok_v2(homs, (side, side), (OUT, OUT), band=32)
    return homs


def test_split_kernel_at_one_channel_matches_plain(depth_dev):
    """The <float, f32, C = 1> instantiation on raw depth against the plain
    version on the same card tensors: f32 2-tap sums in another order than
    cuBLAS's, on values up to 4.5 m (bound TOL times 4.5)."""
    d, homs, ext = (torch.as_tensor(a).to(depth_dev)
                    for a in depth_frames(90))
    before = warp_cuda.split_warp.launches
    out = warp.warp_batch_split(d, homs, (OUT, OUT), ext, stage_b='cuda',
                                planar_out=True, wdtype=torch.float32)
    ref = warp.warp_batch_split(d, homs, (OUT, OUT), ext, stage_b='mxu',
                                planar_out=True, wdtype=torch.float32)
    torch.cuda.synchronize()
    assert warp_cuda.split_warp.launches == before + 1
    assert out.shape == (3, 1, OUT, OUT)
    assert float((out - ref).abs().max()) <= 4.5 * TOL
    assert float(out.max()) > 4.0


def test_split_wrapper_takes_depth_only_as_f32(depth_dev):
    d, homs, ext = (torch.as_tensor(a).to(depth_dev)
                    for a in depth_frames(91))
    m = warp.split_defaults((OUT, OUT))[0]
    residual, scale = warp.decompose_homography(homs, (OUT, OUT), m)
    good = (d, residual, scale, ext, (OUT, OUT), m, 1.0, torch.float32)
    before = warp_cuda.split_warp.launches
    for bad in ((d,) + good[1:7] + (torch.bfloat16,),
                ((d * 50).to(torch.uint8),) + good[1:],
                (torch.cat([d, d], -1),) + good[1:]):
        with pytest.raises(ValueError):
            warp_cuda.split_warp(*bad)
    assert warp_cuda.split_warp.launches == before
    warp_cuda.split_warp(*good)
    torch.cuda.synchronize()
    assert warp_cuda.split_warp.launches == before + 1


@pytest.mark.parametrize('n_ch,planar', [(1, True), (3, False), (3, True)],
                         ids=['1', '3-nhwc', '3-planar'])
def test_banded_kernel_matches_plain(depth_dev, n_ch, planar):
    """Whole canvases with admitted homographies and smaller extents, f32
    values in [0, 1]: the kernel against its plain version (bound TOL)."""
    rng = np.random.RandomState(92 + n_ch + planar)
    img = torch.as_tensor(rng.rand(3, 96, 96, n_ch).astype(np.float32))
    if planar:
        img = img.permute(0, 3, 1, 2).contiguous()
    homs = torch.as_tensor(canvas_homs(93)).to(depth_dev)
    ext = torch.as_tensor(np.array([[96, 90], [88, 96], [96, 96]],
                                   np.int32)).to(depth_dev)
    img = img.to(depth_dev)
    before = warp_banded.banded_warp.launches
    out = warp_banded.banded_warp(img, homs, ext, (OUT, OUT), planar)
    ref = warp_banded.banded_warp_plain(img, homs, ext, (OUT, OUT), planar)
    torch.cuda.synchronize()
    assert warp_banded.banded_warp.launches == before + 1
    assert out.shape == (3, n_ch, OUT, OUT)
    assert float((out - ref).abs().max()) <= TOL


@pytest.mark.parametrize('u8', [True, False], ids=['uint8', 'float32'])
def test_full_scanline_kernel_matches_plain_and_banded(depth_dev, u8):
    """The oracle kernel against its plain version (values as they are:
    bound 255 TOL for uint8), and the banded kernel on the same admitted
    batch: the same device function, so the same bits."""
    rng = np.random.RandomState(94 + u8)
    img = (rng.randint(0, 256, (3, 96, 96, 3)).astype(np.uint8) if u8
           else rng.rand(3, 96, 96, 3).astype(np.float32))
    img = torch.as_tensor(img).to(depth_dev)
    homs = torch.as_tensor(canvas_homs(95)).to(depth_dev)
    ext = torch.as_tensor(np.full((3, 2), 96, np.int32)).to(depth_dev)
    before = warp_banded.full_warp.launches
    out = warp_banded.full_warp(img, homs, ext, (OUT, OUT))
    ref = warp_banded.full_warp_plain(img, homs, ext, (OUT, OUT))
    banded = warp_banded.banded_warp(img.float().contiguous(), homs, ext,
                                     (OUT, OUT))
    torch.cuda.synchronize()
    assert warp_banded.full_warp.launches == before + 1
    assert float((out - ref).abs().max()) <= (255 if u8 else 1) * TOL
    assert torch.equal(out, banded)


def adversarial_homs(kind, side=96):
    """Out->src homographies the banded gate does not admit, each stressing
    the row-shared kernels' walk: strong perspective, minification above
    3x (a step's taps wider than its 32-column window), columns whose map
    is non-finite (w = 0 inside the output), a mirror (columns falling
    along the row), a near-quarter turn (a row's pixels on two columns)."""
    if kind == 'perspective':
        h = [[1.1, 0.2, 4.0], [-0.1, 0.9, 6.0], [6e-3, 4e-3, 1.0]]
    elif kind == 'minify':
        h = [[3.6, 0.1, 2.0], [-0.2, 3.3, 1.0], [1e-4, -2e-4, 1.0]]
    elif kind == 'non_finite':
        # image 0: the column map's w = 1 - u/32 is 0 at u = 32; images 1
        # and 2: the row map's h0 - h6 xs is 0 at xs = 48, the column that
        # row 28 maps every pixel to
        return np.asarray([
            [[1.0, 0.0, 1.0], [0.0, 1.0, 2.0], [-1.0 / 32.0, 0.0, 1.0]],
            [[1.5, 1.0, 20.0], [0.0, 1.0, 2.0], [1.0 / 32.0, 0.0, 1.0]],
            [[1.5, 1.0, 20.0], [0.1, 1.1, 0.0], [1.0 / 32.0, 0.0, 1.0]]],
            np.float32)
    elif kind == 'mirror':
        h = [[-1.3, 0.05, side - 2.0], [0.02, 1.2, 3.0], [-1e-4, 1e-4, 1.0]]
    else:   # quarter turn
        h = [[0.02, 1.1, 2.0], [-1.1, 0.03, side - 3.0], [0.0, 0.0, 1.0]]
    homs = np.asarray([h] * 3, np.float32)
    homs[1, :2, 2] += 1.5
    homs[2, :2, :2] *= 1.07
    return homs


BANDED_FORMS = [('banded', 1, True), ('banded', 3, True),
                ('banded', 3, False), ('oracle', 'u8', False),
                ('oracle', 'f32', False)]


@pytest.mark.parametrize('kind', ['admitted', 'perspective', 'minify',
                                  'non_finite', 'mirror', 'quarter_turn'])
@pytest.mark.parametrize('form', BANDED_FORMS,
                         ids=['1', '3-planar', '3-nhwc', 'oracle-uint8',
                              'oracle-f32'])
def test_row_shared_kernels_equal_the_direct_form(depth_dev, form, kind):
    """The row-shared banded and oracle kernels against their per-pixel
    form (launch_*_direct) on the same inputs: the same expressions in the
    same order, so the same bits. Gate-admitted crops and homographies the
    gate refuses, extents smaller than the canvas, an output of 45 x 77
    (not a multiple of the 32 x 8 block)."""
    entry, n_ch, planar = form
    rng = np.random.RandomState(98)
    hw = (200, 240) if kind == 'minify' else (96, 96)
    homs = (canvas_homs(99) if kind == 'admitted'
            else adversarial_homs(kind, hw[1]))
    homs = torch.as_tensor(homs).to(depth_dev)
    ext = torch.as_tensor(np.array([[hw[0], hw[1] - 7], [hw[0] - 9, hw[1]],
                                    hw], np.int32)).to(depth_dev)
    scal = warp_banded.pack_scalars(homs, ext)
    out_hw = (45, 77)
    if entry == 'oracle':
        img = (rng.randint(0, 256, (3,) + hw + (3,)).astype(np.uint8)
               if n_ch == 'u8' else rng.rand(3, *hw, 3).astype(np.float32))
        img = torch.as_tensor(img).to(depth_dev)
        out = torch.full((3, 3) + out_hw, float('nan'), device=depth_dev)
        direct = torch.full_like(out, float('nan'))
        warp_banded.launch_full(img, scal, out)
        warp_banded.launch_full_direct(img, scal, direct)
    else:
        img = rng.rand(3, *hw, n_ch).astype(np.float32)
        img = torch.as_tensor(img).to(depth_dev)
        if planar:
            img = img.permute(0, 3, 1, 2).contiguous()
        out = torch.full((3, n_ch) + out_hw, float('nan'), device=depth_dev)
        direct = torch.full_like(out, float('nan'))
        warp_banded.launch_banded(img, scal, out, planar)
        warp_banded.launch_banded_direct(img, scal, direct, planar)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, direct)
    assert float(out.abs().max()) > 0


def test_pallas2_split_on_card_matches_plain(depth_dev):
    """warp_batch_split(stage_b='pallas2'): stage A's dense dots (cuBLAS, f32,
    TF32 off) then the banded kernel, against the plain split warp on the
    same card tensors (bound 4.5 TOL on metres)."""
    d, homs, ext = (torch.as_tensor(a).to(depth_dev)
                    for a in depth_frames(96))
    before = warp_banded.banded_warp.launches
    out = warp.warp_batch_split(d, homs, (OUT, OUT), ext, stage_b='pallas2',
                                planar_out=True, wdtype=torch.float32)
    ref = warp.warp_batch_split(d, homs, (OUT, OUT), ext, stage_b='mxu',
                                planar_out=True, wdtype=torch.float32)
    torch.cuda.synchronize()
    assert warp_banded.banded_warp.launches == before + 1
    assert float((out - ref).abs().max()) <= 4.5 * TOL


def test_warp_wrappers_refuse_what_the_kernels_do_not_take(depth_dev):
    img = torch.rand(2, 96, 96, 3, device=depth_dev)
    homs = torch.as_tensor(canvas_homs(97, b=2)).to(depth_dev)
    ext = torch.full((2, 2), 96, dtype=torch.int32, device=depth_dev)
    good = (img, homs, ext, (OUT, OUT))
    before = (warp_banded.banded_warp.launches,
              warp_banded.full_warp.launches)
    for bad in ((img.double(),) + good[1:], (img[..., :2].contiguous(),)
                + good[1:], (img.transpose(1, 2),) + good[1:],
                (img, homs[:1]) + good[2:], (img, homs.cpu()) + good[2:]):
        with pytest.raises(ValueError):
            warp_banded.banded_warp(*bad)
    for bad in ((img[..., :1].contiguous(),) + good[1:],
                (img.half(),) + good[1:]):
        with pytest.raises(ValueError):
            warp_banded.full_warp(*bad)
    assert (warp_banded.banded_warp.launches,
            warp_banded.full_warp.launches) == before


RENORM_SHAPES = [(2, 64, 33, 33), (3, 256, 9, 9), (1, 8, 5, 7)]


@pytest.mark.parametrize('shape', RENORM_SHAPES,
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
def test_renorm_kernels_match_plain(depth_dev, dtype, shape):
    """Forward and backward renorm kernels against their plain versions on
    the same card tensors: the same operations, each rounded where the
    plain version rounds, so the same bits."""
    g = torch.Generator().manual_seed(sum(shape))
    b, c, h, w = shape
    raw = torch.randn(shape, generator=g).to(depth_dev, dtype).contiguous(
        memory_format=torch.channels_last)
    mask_raw = torch.randint(0, 50, (b, 1, h, w), generator=g).to(
        depth_dev, dtype)
    mask_raw[0, :, :2] = 0
    grad = torch.randn(shape, generator=g).to(depth_dev, dtype).contiguous(
        memory_format=torch.channels_last)
    before = (partial_conv.renorm_fwd.launches,
              partial_conv.renorm_bwd.launches)
    out, mout = partial_conv.renorm_fwd(raw, mask_raw, 49.0)
    d_raw = partial_conv.renorm_bwd(grad, mask_raw, 49.0)
    ref_out, ref_mout = partial_conv.renormalize_xla(raw, mask_raw, 49.0)
    ref_d = partial_conv.renorm_bwd_plain(grad, mask_raw, 49.0)
    torch.cuda.synchronize()
    assert (partial_conv.renorm_fwd.launches,
            partial_conv.renorm_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, ref_out) and torch.equal(mout, ref_mout)
    assert torch.equal(d_raw, ref_d)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
def test_partial_conv_use_pallas_on_card(depth_dev, dtype):
    """partial_conv(use_pallas=True) on the card runs the kernels through
    RenormFn; the same convolution with the plain renorm gives the same
    output, mask and gradients (the kernels are bit-equal to the plain
    renorm, and the convolutions are the same calls, with cuDNN held to
    its deterministic algorithms)."""
    g = torch.Generator().manual_seed(98)
    x = torch.randn(2, 16, 21, 21, generator=g).to(depth_dev, dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    mask = (torch.rand(2, 1, 21, 21, generator=g) > 0.1).to(depth_dev)
    kernel = (torch.randn(32, 16, 3, 3, generator=g) * 0.1).to(depth_dev,
                                                                dtype)
    grad = torch.randn(2, 32, 21, 21, generator=g).to(depth_dev, dtype)
    results = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for use_pallas in (True, False):
        xx = x.clone().requires_grad_()
        kk = kernel.clone().contiguous(
            memory_format=torch.channels_last).requires_grad_()
        before = partial_conv.renorm_fwd.launches
        out, mout = partial_conv.partial_conv(xx, mask, kk, 1, 2, 2,
                                              use_pallas=use_pallas)
        assert partial_conv.renorm_fwd.launches == before + use_pallas
        (out.float() * grad.float()).sum().backward()
        results.append((out, mout, xx.grad, kk.grad))
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = deterministic
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_renorm_wrappers_refuse_what_the_kernels_do_not_take(depth_dev):
    raw = torch.randn(2, 16, 9, 9, device=depth_dev).contiguous(
        memory_format=torch.channels_last)
    mask_raw = torch.ones(2, 1, 9, 9, device=depth_dev)
    before = partial_conv.renorm_fwd.launches
    for bad in ((raw.contiguous(), mask_raw), (raw[:, :12], mask_raw),
                (raw.half(), mask_raw.half()), (raw, mask_raw.bfloat16()),
                (raw, mask_raw[:1])):
        with pytest.raises(ValueError):
            partial_conv.renorm_fwd(*bad, 9.0)
    assert partial_conv.renorm_fwd.launches == before


def test_distill_step_on_card_matches_cpu(depth_dev):
    """Two distillation steps (fusion teacher with bn_impl='pallas', depth
    student on colour, -attention) of small f32 models on the card and on
    the CPU from the same weights and batch: losses within 1e-4 relative,
    the student's and the teacher's running statistics within 1e-4 of
    their largest value, the student's parameters within 2 * lr * steps."""
    args = default_depth_args(model='resnet18', side_in=65, stride=32,
                              depth=4, num_joints=5, half_acc=False,
                              bn_impl='pallas', do_teach=True, do_fusion=True,
                              attention=True)
    rng = np.random.RandomState(99)
    batch = dict(color=rng.randn(2, 65, 65, 3).astype(np.float32),
                 depth=rng.uniform(0.02, 0.4, (2, 65, 65, 1)).astype(
                     np.float32),
                 true_cam=(rng.uniform(-300, 300, (2, 5, 3))
                           + [0, 0, 3000]).astype(np.float32),
                 true_val=rng.rand(2, 5) > 0.2,
                 atten_map=rng.rand(2, 3, 3, 1).astype(np.float32))
    kw = dict(block='basic', layers=(1, 1, 1, 1), stride=32, num_joints=5,
              depth=4, bn_impl='pallas')
    results = {}
    for dev in (depth_dev, torch.device('cpu')):
        student = init_weights(PoseResNet(variant='depth', **kw),
                               torch.Generator().manual_seed(0))
        teacher = init_weights(PoseResNet(variant='fusion', **kw),
                               torch.Generator().manual_seed(1))
        for m in (student, teacher):
            m.to(dev, memory_format=torch.channels_last)
        state = steps.init_state(student, args)
        step = steps.make_distill_train_step(args, 2, True, False)
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        outs = [step(state, teacher, tb, args.learn_rate, 0.1)
                for _ in range(2)]
        results[dev.type] = (
            [{k: float(v) for k, v in o.items()} for o in outs],
            {k: v.detach().cpu() for k, v in student.state_dict().items()},
            {k: v.detach().cpu() for k, v in teacher.state_dict().items()})
    (l_gpu, s_gpu, t_gpu), (l_cpu, s_cpu, t_cpu) = (results['cuda'],
                                                    results['cpu'])
    for a, b in zip(l_gpu, l_cpu):
        for k in ('cam_loss', 'dist_loss'):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (k, a[k], b[k])
    for got, ref in ((s_gpu, s_cpu), (t_gpu, t_cpu)):
        for k, v in ref.items():
            if k.endswith(('running_mean', 'running_var')):
                assert float((got[k] - v).abs().max()) <= 1e-4 * float(
                    v.abs().max()), k
    for k, v in s_cpu.items():
        if v.is_floating_point() and 'running' not in k:
            assert float((s_gpu[k] - v).abs().max()) <= (
                2 * args.learn_rate * 2), k


# ------------------------------------------------------------ stem conv


@pytest.fixture
def stem_dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the stem kernel runs only on the '
                    'card')
    runtime.no_tf32()
    stem.build()
    return torch.device('cuda')


def stem_operands(seed, b, cin, side, dev):
    """bf16 x (B, Cin, S, S) and HWIO w on `dev`."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, cin, side, side, generator=g).to(torch.bfloat16)
    w = (torch.randn(7, 7, cin, 64, generator=g) * 0.05).to(torch.bfloat16)
    return x.to(dev), w.to(dev)


@pytest.mark.parametrize('side', [33, 65, 257])
@pytest.mark.parametrize('cin', [1, 3, 4])
def test_stem_kernel_matches_plain(stem_dev, cin, side):
    """stem_conv_fwd on the padded planar input and stem_conv on the
    channels_last input (the model's layout) against the plain version (f32
    cuDNN, TF32 off) on the same bf16 operands: the same exact products
    summed on the tensor cores in another order (each k-group aligned to
    its largest exponent), within K 2^-23 of each output's sum of |terms|
    for K = 49 Cin terms; the bf16 output is the f32 output rounded, bit
    for bit."""
    x, w = stem_operands(cin * 1000 + side, 2, cin, side, stem_dev)
    before = stem.stem_conv.launches
    out = stem.stem_conv_fwd(stem.pad_planar(x, side), w, side)
    out_bf = stem.stem_conv(x.contiguous(memory_format=torch.channels_last),
                            w, torch.bfloat16)
    oihw = w.permute(3, 2, 0, 1)
    ref = stem.stem_conv_plain(x, oihw).permute(0, 2, 3, 1)
    mag = stem.stem_conv_plain(x.abs(), oihw.abs()).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    oh = (side - 1) // 2 + 1
    assert out.shape == (2, oh, oh, 64) and out.dtype == torch.float32
    tol = 49 * cin * 2.0 ** -23
    assert bool(((out - ref).abs() <= tol * mag + 1e-30).all())
    assert torch.equal(out_bf, out.to(torch.bfloat16))
    assert stem.stem_conv.launches == before + 2


def test_stem_route_in_the_model(stem_dev):
    """A bf16 eval forward without autograd runs the stem kernel and agrees
    with the F.conv2d route; a forward that autograd records does not."""
    model = PoseResNet(block='basic', layers=(1, 1, 1, 1), in_channels=4,
                       stride=32, num_joints=5, depth=4, joint_space=True)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(stem_dev, memory_format=torch.channels_last).eval()
    for p in model.parameters():
        p.data = p.data.to(torch.bfloat16)     # BN statistics stay f32
    x = torch.randn(2, 4, 65, 65, generator=torch.Generator().manual_seed(1))
    x = x.to(stem_dev, torch.bfloat16)
    before = stem.stem_conv.launches
    with torch.no_grad():
        got = model.conv1(x)
        ref = F.conv2d(x.float(), model.conv1.weight.float(), stride=2,
                       padding=3).to(torch.bfloat16)
        model(x)
    assert stem.stem_conv.launches == before + 2
    assert torch.equal(got, ref) or float(
        (got.float() - ref.float()).abs().max()) <= 2 ** -7 * float(
            ref.float().abs().max())
    model(x)[0].float().sum().backward()
    assert stem.stem_conv.launches == before + 2


def test_stem_wrapper_refuses_what_the_kernel_does_not_take(stem_dev):
    x, w = stem_operands(5, 1, 4, 33, stem_dev)
    before = stem.stem_conv.launches
    for bad in ((x.float(), w), (x, w.float()), (x[:, :2], w),
                (x, w.permute(1, 0, 2, 3))):
        with pytest.raises(ValueError):
            stem.stem_conv(*bad)
    packed = stem.pack_weight(w)
    for bad in (packed[:64], packed.float(), packed.t().contiguous().t()):
        with pytest.raises(ValueError):
            stem.stem_conv(x, w, torch.bfloat16, bad)
    with pytest.raises(ValueError):
        stem.stem_conv(x, w, torch.float16)
    assert stem.stem_conv.launches == before


# -------------------------------------------------- training augmentations


def augment_inputs(seed, b=4):
    """Canvases and split-gated crops, partial homographies (K_old^-1 of
    the crops) with mild distortion, a 3-sprite bank and the draws."""
    from pose_tpu_torch.data import augment
    imgs, homs, ext = frames(seed, small_extents=True, b=b)
    kmat = np.array([[100.0, 0, S / 2], [0, 100.0, S / 2], [0, 0, 1]])
    parts = (np.linalg.inv(kmat) @ homs.astype(np.float64)).astype(
        np.float32)
    kmats = np.broadcast_to(kmat, (b, 3, 3)).astype(np.float32)
    rng = np.random.RandomState(seed)
    dist = np.stack([rng.uniform(-0.25, -0.1, b), rng.uniform(0, 0.05, b),
                     rng.uniform(-1e-3, 1e-3, b),
                     rng.uniform(-1e-3, 1e-3, b), np.zeros(b)],
                    -1).astype(np.float32)
    g = torch.Generator().manual_seed(seed)
    bank = (torch.rand((3, 256, 256, 3), generator=g),
            (torch.rand((3, 256, 256), generator=g) > 0.3).float(),
            torch.tensor([[60, 80], [256, 200], [90, 40]], dtype=torch.int32))
    return (imgs, homs, ext, parts, kmats, dist, bank,
            augment.draw_augment(g, b, 3))


@pytest.mark.parametrize('stream', ['split', 'occluded', 'general'])
def test_augment_streams_on_card_match_cpu(dev, stream, monkeypatch):
    """Each colour stream with -colour -eraser (and the paste) on the card
    against the same on the CPU, the same draws and the card's bf16 dot
    operands on both; the split stream against the CPU's chain on the
    kernel's own crops (the kernel's 1e-5 against its plain version would
    cross the truncation's 1/255 steps). Bound: 2e-4 on normalised values
    but at most 1 of 1,000 moved by one uint8 level, none further."""
    from pose_tpu_torch.data import augment
    from pose_tpu_torch.ops import occluder
    imgs, homs, ext, parts, kmats, dist, bank, draws = augment_inputs(31)

    def on(d, *arrays):
        return [torch.as_tensor(a).to(d) for a in arrays]

    def run(d):
        bk = tuple(t.to(d) for t in bank)
        if stream == 'split':
            return augment.process_color_batch(
                *on(d, imgs, homs, ext), draws.to(d), OUT, True, True,
                warp_impl='split')
        if stream == 'occluded':
            return augment.process_color_batch_occluded(
                *on(d, imgs, homs, ext), draws.to(d), bk, OUT, True, True)
        return augment.process_color_batch_general(
            *on(d, imgs, parts, kmats, dist, ext), draws.to(d), OUT, True,
            True, bank=bk)

    before = warp_cuda.split_warp.launches
    got = run(dev).cpu()
    assert warp_cuda.split_warp.launches == before + (stream == 'split')
    if stream == 'split':
        crops = warp.warp_batch_split(*on(dev, imgs, homs), (OUT, OUT),
                                      torch.as_tensor(ext).to(dev),
                                      planar_out=True)
        c = colour.random_color_batch_planar(
            torch.clamp(crops, 0.0, 1.0).cpu(), draws.colour)
        ref = colour.normalize_imagenet(occluder.random_erase(
            c.permute(0, 2, 3, 1), draws.erase_rgb, draws.erase_area,
            draws.erase_aspect, draws.erase_pos))
    else:
        monkeypatch.setattr(warp, '_default_wdtype',
                            lambda device: torch.bfloat16)
        ref = run(torch.device('cpu'))
    diff = (got - ref).abs()
    assert float(diff.max()) <= 1 / 255 / 0.224 + 2e-4
    assert int((diff > 2e-4).sum()) <= diff.numel() / 1000


# ------------------------------------------------------------ int8 conv


@pytest.fixture
def int8_dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the int8 conv kernel runs only on '
                    'the card')
    from pose_tpu_torch.ops import int8_conv
    int8_conv.build()
    return torch.device('cuda')


# (B, Cin, H, Cout, kernel, stride, padding, dilation): ragged K (the
# stems' 49, 147, 196), ragged N (the heads' 19 and 304), stride 2,
# dilation 2, B = 1
INT8_CASES = {
    'stem_cin1': (2, 1, 65, 64, 7, 2, 3, 1),
    'stem_cin3': (2, 3, 65, 64, 7, 2, 3, 1),
    'stem_cin4_b1': (1, 4, 65, 64, 7, 2, 3, 1),
    '3x3_s2': (2, 128, 33, 128, 3, 2, 1, 1),
    '3x3_dil2': (2, 256, 17, 256, 3, 1, 2, 2),
    '1x1_s2': (2, 256, 33, 512, 1, 2, 0, 1),
    'head_19': (1, 2048, 17, 19, 3, 1, 1, 1),
    'head_304_b1': (1, 2048, 17, 304, 3, 1, 1, 1),
}


@pytest.mark.parametrize('layout', ['channels_last', 'nchw'])
@pytest.mark.parametrize('extreme', [False, True], ids=['random', '127'])
@pytest.mark.parametrize('case', list(INT8_CASES))
def test_int8_kernel_matches_plain(int8_dev, case, extreme, layout):
    """The int8 kernel against its plain version (f64 sums, exact) on the
    same card tensors: equal bit for bit, on random codes and at +-127
    (the largest sums), through the vector path (channels_last) and the
    byte path (an NCHW input, read through its strides)."""
    from pose_tpu_torch.ops import int8_conv as i8
    b, cin, h, cout, k, s, p, d = INT8_CASES[case]
    g = torch.Generator(device=int8_dev).manual_seed(len(case))
    if extreme:
        x = torch.full((b, cin, h, h), 127, dtype=torch.int8,
                       device=int8_dev)
        w = torch.full((cout, cin, k, k), -127, dtype=torch.int8,
                       device=int8_dev)
    else:
        x = torch.randint(-127, 128, (b, cin, h, h), generator=g,
                          device=int8_dev).to(torch.int8)
        w = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                          device=int8_dev).to(torch.int8)
    if layout == 'channels_last':
        x = x.contiguous(memory_format=torch.channels_last)
    geom = i8.Geometry(cout, cin, (k, k), (s, s), (p, p), (d, d))
    before = i8.int8_conv.launches
    got = i8.int8_conv(x, i8.pack_weight(w), geom)
    ref = i8.int8_conv_plain(x, w, geom)
    torch.cuda.synchronize()
    assert i8.int8_conv.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ref)


def test_int8_wrapper_refuses_what_the_kernel_does_not_take(int8_dev):
    from pose_tpu_torch.ops import int8_conv as i8
    x = torch.zeros((1, 64, 9, 9), dtype=torch.int8, device=int8_dev)
    w = torch.zeros((64, 64, 3, 3), dtype=torch.int8, device=int8_dev)
    geom = i8.Geometry(64, 64, (3, 3), (1, 1), (1, 1), (1, 1))
    packed = i8.pack_weight(w)
    before = i8.int8_conv.launches
    for bad in ((x.float(), packed, geom), (x[:, :32], packed, geom),
                (x, packed[:, :64], geom), (x, packed.cpu(), geom),
                (x, packed.t().contiguous().t(), geom),
                (x, packed, geom._replace(stride=(0, 0)))):
        with pytest.raises(ValueError):
            i8.int8_conv(*bad)
    assert i8.int8_conv.launches == before


def fused_args(dev, case, dtype, with_bias, seed):
    """A float input (channels_last) and a QuantizedConv's operands for one
    INT8_CASES conv: a seeded int8 weight, x_scale its calibrated 0-d f32
    (absmax 0.8 of the input's, so some codes clip), per-channel weight
    scales and their (Cout, 1, 1) products, a (Cout, 1, 1) bias in x's
    dtype or None."""
    from pose_tpu_torch.ops import int8_conv as i8
    b, cin, h, cout, k, s, p, d = INT8_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (2 * torch.randn((b, cin, h, h), generator=g, device=dev)).to(
        dtype).contiguous(memory_format=torch.channels_last)
    w = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                      device=dev).to(torch.int8)
    geom = i8.Geometry(cout, cin, (k, k), (s, s), (p, p), (d, d))
    x_scale = torch.tensor(np.float32(0.8 * float(x.float().abs().max())
                                      / 127.0), device=dev)
    sw = torch.rand((cout,), generator=g, device=dev) * 1e-2 + 1e-4
    scale = (x_scale * sw)[:, None, None]
    bias = (torch.randn((cout, 1, 1), generator=g, device=dev).to(dtype)
            if with_bias else None)
    return x, (i8.pack_weight(w), geom, x_scale, scale, bias)


def same_bits(a, b):
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(view), b.contiguous().view(view)))


@pytest.mark.parametrize('with_bias', [False, True], ids=['nobias', 'bias'])
@pytest.mark.parametrize('acc', ['int32', 'bf16'])
@pytest.mark.parametrize('dtype', ['bf16', 'f32'])
@pytest.mark.parametrize('case', list(INT8_CASES))
def test_quantized_conv_matches_plain(int8_dev, case, dtype, acc,
                                      with_bias):
    """quantized_conv (the quantize pass and the conv with its fused
    epilogue) against quantized_conv_plain on the same card tensors: equal
    bit for bit (the same IEEE division, round half to even, exact int32
    sums, the same roundings in the dequant; no FMA), channels_last in
    x's dtype, one launch of each kernel."""
    from pose_tpu_torch.ops import int8_conv as i8
    dt = torch.bfloat16 if dtype == 'bf16' else torch.float32
    acc_dtype = torch.int32 if acc == 'int32' else torch.bfloat16
    x, ops = fused_args(int8_dev, case, dt, with_bias, len(case))
    before = (i8.quantized_conv.launches, i8.quantized_conv.quantize_launches)
    got = i8.quantized_conv(x, *ops, acc_dtype)
    ref = i8.quantized_conv_plain(x, *ops, acc_dtype)
    torch.cuda.synchronize()
    assert (i8.quantized_conv.launches,
            i8.quantized_conv.quantize_launches) == tuple(
                n + 1 for n in before)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert same_bits(got, ref)


@pytest.mark.parametrize('layout', ['nchw', 'sliced'])
def test_quantized_conv_reads_any_strides(int8_dev, layout):
    """The quantize pass reads x through its strides: an NCHW input and a
    channel slice of a wider one give the plain chain's bits."""
    from pose_tpu_torch.ops import int8_conv as i8
    x, ops = fused_args(int8_dev, '3x3_s2', torch.bfloat16, True, 5)
    if layout == 'nchw':
        x = x.contiguous()
    else:
        x = torch.cat([x, x], 1).contiguous(
            memory_format=torch.channels_last)[:, 3:3 + x.shape[1]]
    got = i8.quantized_conv(x, *ops, torch.int32)
    ref = i8.quantized_conv_plain(x, *ops, torch.int32)
    torch.cuda.synchronize()
    assert same_bits(got, ref)


@pytest.mark.parametrize('dtype', ['bf16', 'f32'])
def test_quantized_conv_split_k_at_layer4(int8_dev, dtype):
    """The cam head's shape at batch 8 (17^2, K = 3 3 2048 = 18,432, 304
    channels: fewer output tiles than SMs, so the planner splits K): the
    split blocks' int32 partials add to the plain chain's bits, with
    codes near +-127 so the sums pass 2^24 in magnitude, int32 and bf16
    accumulators."""
    from pose_tpu_torch.ops import int8_conv as i8
    dt = torch.bfloat16 if dtype == 'bf16' else torch.float32
    geom = i8.Geometry(304, 2048, (3, 3), (1, 1), (1, 1), (1, 1))
    sms = torch.cuda.get_device_properties(int8_dev).multi_processor_count
    assert i8.plan(8 * 17 * 17, 304, 18432, sms).split > 1
    g = torch.Generator(device=int8_dev).manual_seed(11)
    x = (100 + 27 * torch.rand((8, 2048, 17, 17), generator=g,
                               device=int8_dev)).to(dt).contiguous(
        memory_format=torch.channels_last)
    w = torch.randint(100, 128, (304, 2048, 3, 3), generator=g,
                      device=int8_dev).to(torch.int8)
    x_scale = torch.tensor(1.0, device=int8_dev)
    scale = torch.full((304, 1, 1), 1e-6, device=int8_dev)
    for acc in (torch.int32, torch.bfloat16):
        args = (i8.pack_weight(w), geom, x_scale, scale, None, acc)
        got = i8.quantized_conv(x, *args)
        ref = i8.quantized_conv_plain(x, *args)
        torch.cuda.synchronize()
        assert same_bits(got, ref)
    exact = i8.int8_conv(x.to(torch.int8), i8.pack_weight(w), geom)
    assert int(exact.min()) > 2 ** 24


def test_quantized_conv_bf16_accumulator_rounds_twice(int8_dev):
    """acc_dtype bf16 rounds each int32 sum as y.to(torch.bfloat16) does:
    to f32, then to bf16. A sum of 2^24 + 2^16 + 1 rounds to 2^24 + 2^16
    in f32 (ties to even), a bf16 tie, which goes to 2^24; rounded once it
    would be 2^24 + 2^17. Its negative likewise."""
    from pose_tpu_torch.ops import int8_conv as i8
    cin = 1088
    # 1044 x 127 x 127 + 127 x 32 + 13 x 1 = 2^24 + 2^16 + 1
    codes = torch.zeros(cin)
    codes[:1045] = 127
    codes[1045] = 13
    w = torch.zeros((2, cin, 1, 1), dtype=torch.int8)
    w[:, :1044] = 127
    w[:, 1044] = 32
    w[:, 1045] = 1
    w[1] = -w[1]
    geom = i8.Geometry(2, cin, (1, 1), (1, 1), (0, 0), (1, 1))
    x = codes.reshape(1, cin, 1, 1).to(int8_dev)
    args = (i8.pack_weight(w).to(int8_dev), geom,
            torch.tensor(1.0, device=int8_dev),
            torch.ones((2, 1, 1), device=int8_dev), None, torch.bfloat16)
    got = i8.quantized_conv(x, *args)
    ref = i8.quantized_conv_plain(x, *args)
    torch.cuda.synchronize()
    assert same_bits(got, ref)
    assert got.flatten().tolist() == [2.0 ** 24, -2.0 ** 24]


def test_quantized_conv_under_inference_mode(int8_dev):
    """Under torch.inference_mode() (the Predictor's), with the input
    changed in place between two calls: each call reads the input as it
    is then (nothing is cached by tensor version)."""
    from pose_tpu_torch.ops import int8_conv as i8
    x, ops = fused_args(int8_dev, '1x1_s2', torch.bfloat16, False, 7)
    with torch.inference_mode():
        x = x.clone()
        first = i8.quantized_conv(x, *ops, torch.int32)
        want = i8.quantized_conv_plain(x, *ops, torch.int32)
        x.mul_(-0.5)
        second = i8.quantized_conv(x, *ops, torch.int32)
        want2 = i8.quantized_conv_plain(x, *ops, torch.int32)
    torch.cuda.synchronize()
    assert same_bits(first, want) and same_bits(second, want2)
    assert not torch.equal(first, second)


def test_quantized_conv_refuses_what_the_kernels_do_not_take(int8_dev):
    from pose_tpu_torch.ops import int8_conv as i8
    x, (packed, geom, xs, scale, bias) = fused_args(
        int8_dev, '3x3_s2', torch.bfloat16, True, 9)
    good = (x, packed, geom, xs, scale, bias, torch.int32)
    bad = [(0, x.half()), (0, x.to(torch.int8)), (0, x[:, :64]),
           (1, packed[:, :64]), (1, packed.cpu()), (3, xs.reshape(1)),
           (3, xs.double()), (3, xs.cpu()), (4, scale[:64]),
           (4, scale.double()), (5, bias.double()), (5, bias[:3]),
           (6, torch.float16), (2, geom._replace(dilation=(0, 0)))]
    before = (i8.quantized_conv.launches, i8.quantized_conv.quantize_launches)
    for i, value in bad:
        args = list(good)
        args[i] = value
        with pytest.raises(ValueError):
            i8.quantized_conv(*args)
    assert (i8.quantized_conv.launches,
            i8.quantized_conv.quantize_launches) == before


@pytest.mark.parametrize('half_acc', [False, True], ids=['f32', 'bf16'])
def test_quantized_predictor_on_card_equals_plain_kernel_forward(
        int8_dev, half_acc, monkeypatch):
    """A quantized Predictor's forward on the card makes one quantized_conv
    call at every quantized conv (one quantize and one conv launch each,
    the exact form and the stem kernel not at all), and equals the same
    forward on the card with the plain chain (quantized_conv_plain): the
    int32 sums are exact on both routes, and everything else is the same
    operations in the same roundings."""
    from pose_tpu_torch import quant
    from pose_tpu_torch.ops import int8_conv as i8
    args = serve.default_args(model='resnet18', side_in=65, stride=32,
                              depth=4, num_joints=5, half_acc=half_acc,
                              extra_channel=True)
    p = serve.Predictor(args, 'rgb', batch_size=4, device=int8_dev, seed=3)
    rng = np.random.RandomState(3)
    x = rng.randn(4, 65, 65, 4).astype(np.float32)
    p.quantize([x])
    n_q = len(quant.quantized_convs(p._quant_model))
    fused = i8.quantized_conv
    before = (fused.launches, fused.quantize_launches, i8.int8_conv.launches,
              stem.stem_conv.launches)
    got = p.predict_crops(x)
    assert (fused.launches, fused.quantize_launches, i8.int8_conv.launches,
            stem.stem_conv.launches) == (before[0] + n_q, before[1] + n_q,
                                         before[2], before[3])
    monkeypatch.setattr(quant, 'quantized_conv', i8.quantized_conv_plain)
    ref = p.predict_crops(x)
    for k in ref:
        assert np.all(np.isfinite(got[k]))
        np.testing.assert_array_equal(got[k], ref[k])


def test_quantized_predictor_two_threads_equal_serial(int8_dev):
    """Two threads serving one quantized Predictor at once on the default
    stream: each call quantizes into memory of its own, so every answer
    equals the serial one bit for bit, and every batch makes one conv and
    one quantize launch at each quantized conv."""
    import threading

    from pose_tpu_torch import quant
    from pose_tpu_torch.ops import int8_conv as i8
    args = serve.default_args(model='resnet18', side_in=65, stride=32,
                              depth=4, num_joints=5, half_acc=True,
                              extra_channel=True)
    p = serve.Predictor(args, 'rgb', batch_size=4, device=int8_dev, seed=5)
    rng = np.random.RandomState(5)
    xs = [rng.randn(4, 65, 65, 4).astype(np.float32) for _ in range(2)]
    p.quantize(xs)
    n_q = len(quant.quantized_convs(p._quant_model))
    serial = [p.predict_crops(x) for x in xs]
    fused = i8.quantized_conv
    before = (fused.launches, fused.quantize_launches)
    got = [[], []]
    errors = []
    n_calls = 20

    def serve_one(k):
        try:
            for _ in range(n_calls):
                got[k].append(p.predict_crops(xs[k]))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=serve_one, args=(k,))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert (fused.launches - before[0], fused.quantize_launches
            - before[1]) == (2 * n_calls * n_q, 2 * n_calls * n_q)
    for k in range(2):
        assert len(got[k]) == n_calls
        for out in got[k]:
            for name in serial[k]:
                np.testing.assert_array_equal(out[name], serial[k][name])


# ------------------------------------------------ CUDA graph and artifacts


def graph_predictor(dev, quantized, seed=7):
    """A small half_acc rgb Predictor (-extra_channel: the stem kernel at
    Cin 4) on the card, quantized when asked, and two batches of crops;
    the first also calibrates."""
    args = serve.default_args(model='resnet18', side_in=65, stride=32,
                              depth=4, num_joints=5, half_acc=True,
                              extra_channel=True)
    p = serve.Predictor(args, 'rgb', batch_size=4, device=dev, seed=seed)
    rng = np.random.RandomState(seed)
    xs = [rng.randn(4, 65, 65, 4).astype(np.float32) for _ in range(2)]
    if quantized:
        p.quantize(xs[:1])
    return p, xs


def assert_same_answers(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.all(np.isfinite(got[k]))
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize('quantized', [False, True], ids=['bf16', 'int8'])
def test_graph_replay_equals_eager(int8_dev, quantized):
    """aot_compile captures the forward in one CUDA graph; its replays
    answer as the eager forward bit for bit (the same kernels on the same
    inputs), a ragged batch too, and make no wrapper call (the launch
    counters stand still)."""
    from pose_tpu_torch.ops import int8_conv as i8
    p, xs = graph_predictor(int8_dev, quantized)
    eager = [p.predict_crops(x) for x in xs] + [p.predict_crops(xs[0][:3])]
    p.aot_compile()
    assert p._graph is not None and p.aot_compile() == p._run
    graph = p._graph
    before = (stem.stem_conv.launches, i8.quantized_conv.launches)
    got = [p.predict_crops(x) for x in xs] + [p.predict_crops(xs[0][:3])]
    assert (stem.stem_conv.launches, i8.quantized_conv.launches) == before
    assert p._graph is graph
    for g, e in zip(got, eager):
        assert_same_answers(g, e)


def test_graphed_quantized_predictor_two_threads_equal_serial(int8_dev):
    """Two threads replaying one graphed quantized Predictor at once: the
    lock across copy-in, replay and clone keeps every answer equal to the
    serial one."""
    import threading

    p, xs = graph_predictor(int8_dev, True, seed=8)
    p.aot_compile()
    serial = [p.predict_crops(x) for x in xs]
    got, errors = [[], []], []

    def serve_one(k):
        try:
            for _ in range(20):
                got[k].append(p.predict_crops(xs[k]))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=serve_one, args=(k,))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for k in range(2):
        assert len(got[k]) == 20
        for out in got[k]:
            assert_same_answers(out, serial[k])


def test_quantize_after_aot_compile_recaptures(int8_dev):
    """quantize_with_scales drops the float graph; the next aot_compile
    captures the int8 forward, which answers as a fresh Predictor
    quantized with the same scales, eagerly."""
    p, xs = graph_predictor(int8_dev, False, seed=9)
    p.aot_compile()
    float_graph = p._graph
    scales = p.make_calibrator().update(xs[:1]).scales
    p.quantize_with_scales(scales)
    assert p._graph is None
    p.aot_compile()
    assert p._graph is not None and p._graph is not float_graph
    fresh, _ = graph_predictor(int8_dev, False, seed=9)
    fresh.quantize_with_scales(scales)
    for x in xs:
        assert_same_answers(p.predict_crops(x), fresh.predict_crops(x))


def test_eager_quantized_conv_between_replays(int8_dev):
    """The scratch trap: the graph's int8 convs quantize into buffers of
    the graph's own, so an eager QuantizedConv call in the capturing thread
    between two replays, at a larger input that grows the thread's eager
    scratch, leaves the replay's answers unchanged, and tensors allocated
    afterwards are not written by the replay."""
    from pose_tpu_torch import quant
    p, xs = graph_predictor(int8_dev, True, seed=10)
    p.aot_compile()
    first = p.predict_crops(xs[0])
    conv = next(iter(quant.quantized_convs(p._quant_model).values()))
    big = torch.randn((64, conv.geom.cin, 65, 65), device=int8_dev,
                      dtype=torch.bfloat16)
    with torch.inference_mode():
        conv(big)
    canaries = [torch.full((1 << 20,), 7, dtype=torch.uint8,
                           device=int8_dev) for _ in range(8)]
    again = p.predict_crops(xs[0])
    torch.cuda.synchronize()
    assert_same_answers(again, first)
    for c in canaries:
        assert bool((c == 7).all())


@pytest.mark.parametrize('quantized', [False, True], ids=['bf16', 'int8'])
def test_artifact_on_card_equals_eager(int8_dev, quantized, tmp_path):
    """An artifact exported on the card loads and answers as the eager
    Predictor, bit for bit, eagerly and under its own graph; another
    device is refused."""
    p, xs = graph_predictor(int8_dev, quantized, seed=11)
    path = p.export_artifact(str(tmp_path / 'pose.pt2'))
    want = [p.predict_crops(x) for x in xs]
    art = serve.ArtifactPredictor(path, device=int8_dev)
    assert art.in_shapes == ((4, 65, 65, 4),)
    assert art.out_shapes == ((4, 5, 3), (4, 5, 2))
    for x, w in zip(xs, want):
        assert_same_answers(art.predict_crops(x), w)
    art.aot_compile()
    assert art._graph is not None
    for x, w in zip(xs, want):
        assert_same_answers(art.predict_crops(x), w)
    with pytest.raises(ValueError, match='exported on cuda'):
        serve.ArtifactPredictor(path, device='cpu')
