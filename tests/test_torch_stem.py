"""pose_tpu_torch.ops.stem (the 7x7/2 stem convolution) held against JAX's
planar stem kernel (pose_tpu/ops/stem_pallas.py) on the CPU: its geometry,
the plain version against XLA's bf16 convolution with f32 accumulation
(which tests/test_stem_pallas.py proves bit-equal to the Pallas kernel),
one case against the Pallas kernel itself in interpret mode, and the
model's route through the stem op. The card's kernel against the plain
version is in tests/test_torch_cuda.py; the test marked cuda here skips
without a card."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pose_tpu.ops import stem_pallas as jstem

from pose_tpu_torch.models import PoseResNet, init_weights
from pose_tpu_torch.ops import stem
from pose_tpu_torch.train import default_train_args, steps


def operands(seed, b, cin, side):
    """bf16-representable input (B, Cin, S, S) and HWIO weights, as f32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, cin, side, side).astype(np.float32)
    w = (rng.randn(7, 7, cin, 64) * 0.05).astype(np.float32)
    as_bf16 = lambda a: torch.as_tensor(a).to(torch.bfloat16)   # noqa: E731
    return as_bf16(x), as_bf16(w)


def magnitude(x, w_hwio):
    """Sum of |terms| of each output, NHWC f64."""
    return F.conv2d(x.double().abs(), w_hwio.double().abs().permute(3, 2, 0, 1),
                    stride=2, padding=3).permute(0, 2, 3, 1).numpy()


def xla_conv(x, w_hwio):
    """JAX's reference of the kernel: XLA's bf16 conv, f32 accumulation."""
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).transpose(
            0, 2, 3, 1),
        jnp.asarray(w_hwio.float().numpy()).astype(jnp.bfloat16), (2, 2),
        [(3, 3), (3, 3)], dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=jnp.float32))


@pytest.mark.parametrize('side', [33, 65, 129, 257])
def test_plan_and_pad_planar_match_jax(side):
    assert stem.plan(side) == jstem.plan(side)
    x, _ = operands(side, 1, 4, side)
    ref = np.asarray(jstem.pad_planar(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), side))
    got = stem.pad_planar(x, side)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))
    if side == 257:
        assert stem.plan(side) == (129, 17, 280, 266, 133)


@pytest.mark.parametrize('side', [33, 65])
@pytest.mark.parametrize('cin', [1, 3, 4])
def test_plain_matches_xla_bf16_conv(cin, side):
    """The plain version (F.conv2d on the f32 values of the bf16 operands;
    every product exact in f32) against XLA's bf16 conv with f32
    accumulation: the same f32 sums in another order, within 1e-6 of each
    output's sum of |terms| (measured 0.0: equal here)."""
    x, w = operands(cin * 100 + side, 2, cin, side)
    ref = xla_conv(x, w)
    got = stem.stem_conv_plain(x, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.all(np.abs(got.numpy() - ref) <= 1e-6 * magnitude(x, w))


def test_stem_conv_fwd_matches_the_pallas_kernel_interpreted():
    """JAX's entry on its padded planar input against the Pallas kernel in
    interpret mode (side 33, Cin 4): f32 out, within 1e-6 of Σ|terms|
    (measured 0.0)."""
    x, w = operands(7, 2, 4, 33)
    xp = stem.pad_planar(x, 33)
    ref = np.asarray(jstem.stem_conv_fwd(
        jnp.asarray(xp.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w.float().numpy()), 33, interpret=True))
    got = stem.stem_conv_fwd(xp, w, 33)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (
        2, 17, 17, 64)
    assert np.all(np.abs(got.numpy() - ref) <= 1e-6 * magnitude(x, w))


def im2col(x, cin):
    """(B, Cin, S, S) -> (B, OH, OW, K) patches in the kernel's K order
    (stem.K_LAYOUT: kh, kw, ci, each padded), the padded taps zero."""
    kh, kw, cp = stem.K_LAYOUT[cin]
    b, _, side, _ = x.shape
    oh = (side - 1) // 2 + 1
    cols = F.unfold(x, 7, padding=3, stride=2)            # (B, Cin 49, L)
    cols = cols.reshape(b, cin, 7, 7, oh, oh).permute(0, 4, 5, 2, 3, 1)
    patches = torch.zeros((b, oh, oh, kh, kw, cp), dtype=x.dtype)
    patches[..., :7, :7, :cin] = cols
    return patches.reshape(b, oh, oh, kh * kw * cp)


def test_pack_weight_pins_the_kernel_layout():
    """K is (kh, kw, ci) padded to 7 x 8 x 4 = 224 (Cin 3 and 4) or 8 x 8 =
    64 (Cin 1), a multiple of the MMA's k-step of 16, and every padded row
    of the packed weight is zero."""
    for cin, k in ((1, 64), (3, 224), (4, 224)):
        _, w = operands(cin, 1, cin, 9)
        packed = stem.pack_weight(w)
        assert packed.shape == (k, 64) and packed.dtype == torch.bfloat16
        assert k % 16 == 0
        grid = packed.reshape(*stem.K_LAYOUT[cin], 64)
        assert torch.equal(grid[:7, :7, :cin], w)
        pad = torch.ones_like(grid, dtype=torch.bool)
        pad[:7, :7, :cin] = False
        assert not bool(grid[pad].any())


@pytest.mark.parametrize('side', [33, 65])
@pytest.mark.parametrize('cin', [1, 3, 4])
def test_implicit_gemm_layout_matches_plain_and_the_pallas_kernel(cin, side):
    """The kernel's formulation, im2col in its padded K order times the
    packed (K, 64) weight, at f64 (every product and sum exact enough)
    against the plain version and JAX's stem_conv_fwd in interpret mode:
    both f32 sums of the same exact products, within 49 Cin 2^-24 of each
    output's sum of |terms| (f32 rounding of a 49 Cin-term sum)."""
    x, w = operands(cin * 10 + side, 2, cin, side)
    gemm = (im2col(x.double(), cin) @ stem.pack_weight(w).double()).numpy()
    tol = 49 * cin * 2.0 ** -24 * magnitude(x, w)
    plain = stem.stem_conv_plain(x, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    assert np.all(np.abs(plain.numpy() - gemm) <= tol)
    xp = stem.pad_planar(x, side)
    ref = np.asarray(jstem.stem_conv_fwd(
        jnp.asarray(xp.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w.float().numpy()), side, interpret=True))
    assert ref.shape == gemm.shape
    assert np.all(np.abs(ref - gemm) <= tol)


def test_stem_conv_on_the_cpu_is_the_plain_version():
    """The wrapper on a CPU tensor: the plain version, NHWC, f32 or its
    bf16 rounding; nothing counted as a launch. The padded input of the
    wrong size is refused."""
    x, w = operands(8, 2, 3, 33)
    before = stem.stem_conv.launches
    f32 = stem.stem_conv(x, w, torch.float32)
    bf16 = stem.stem_conv(x, w, torch.bfloat16)
    ref = stem.stem_conv_plain(x, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    assert torch.equal(f32, ref) and torch.equal(bf16, ref.to(torch.bfloat16))
    assert stem.stem_conv.launches == before
    with pytest.raises(ValueError):
        stem.stem_conv_fwd(x, w, 33)


# ------------------------------------------------------------- model route


def route_args(**over):
    base = dict(model='resnet18', side_in=65, stride=32, num_joints=5,
                depth=4, batch_size=2, half_acc=True, bn_impl='xla')
    base.update(over)
    return default_train_args(**base)


def route_model():
    model = PoseResNet(block='basic', layers=(1, 1, 1, 1), in_channels=4,
                       stride=32, num_joints=5, depth=4, joint_space=True,
                       bn_impl='xla')
    init_weights(model, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    for name, buf in model.named_buffers():
        if name.endswith('running_mean'):
            buf.normal_(0.0, 0.1, generator=g)
        elif name.endswith('running_var'):
            buf.uniform_(0.5, 1.5, generator=g)
    return model.to(memory_format=torch.channels_last)


def route_batch(seed):
    rng = np.random.RandomState(seed)
    valid = rng.rand(2, 5) > 0.2
    valid[:, 2] = True
    return dict(
        image=torch.as_tensor(rng.randn(2, 65, 65, 4).astype(np.float32)),
        true_cam=torch.as_tensor((rng.uniform(-300, 300, (2, 5, 3))
                                  + [0, 0, 3000]).astype(np.float32)),
        true_mat=torch.as_tensor(rng.uniform(5, 60, (2, 5, 2)).astype(
            np.float32)),
        true_val=torch.as_tensor(valid),
        intrinsics=torch.as_tensor(np.tile(np.array(
            [[500., 0, 32], [0, 500., 32], [0, 0, 1]], np.float32),
            (2, 1, 1))))


@pytest.fixture
def counted(monkeypatch):
    """Count the model's calls into the stem op (its kernel wrapper)."""
    calls = []
    wrapped = stem.stem_conv

    def counting(x, w_hwio, out_dtype=torch.float32, w_packed=None):
        calls.append((x.dtype, tuple(x.shape), out_dtype))
        return wrapped(x, w_hwio, out_dtype, w_packed)
    monkeypatch.setattr(stem, 'stem_conv', counting)
    return calls


def test_bf16_eval_forward_takes_the_stem_route(counted, monkeypatch):
    """The -half_acc eval step (bf16 parameters and image, no autograd)
    runs conv1 through the stem op; its outputs against the same step with
    the route off (F.conv2d in bf16) within test_torch_serve's half_acc
    bounds (5 mm relat_cam, 0.2 px spec_mat; measured 0.39 mm and 0.019
    px: F.conv2d's bf16 sums round differently in a few outputs, see the
    next test, and the bf16 trunk carries that on)."""
    args = route_args()
    model = route_model()
    state = steps.init_state(model, args)
    batch = route_batch(40)
    step = steps.make_rgb_eval_step(args, 2)
    out = step(state, batch)
    assert counted == [(torch.bfloat16, (2, 4, 65, 65), torch.bfloat16)]
    monkeypatch.setattr(stem, 'CIN', ())
    ref = step(state, batch)
    assert len(counted) == 1
    for k, tol in (('relat_cam', 5.0), ('spec_cam', 5.0), ('spec_mat', 0.2)):
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=tol)


def test_stem_route_matches_f_conv2d_at_the_stem(counted):
    """conv1 alone, bf16 in, no grad: the route's output is the f32 sum
    rounded once to bf16. F.conv2d's bf16 result on the CPU rounds inside
    its sums too: 8 of 139392 outputs differ, by at most 1.1e-3 of the
    largest |output| (measured); bound 2^-7 of it, the bf16 bound of
    test_torch_model."""
    model = route_model()
    conv = model.conv1.to(torch.bfloat16)
    x = route_batch(41)['image'].permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.no_grad():
        got = conv(x)
        ref = F.conv2d(x, conv.weight, stride=2, padding=3)
        exact = stem.stem_conv_plain(x, conv.weight).to(torch.bfloat16)
    assert len(counted) == 1 and got.shape == ref.shape == (2, 64, 33, 33)
    assert torch.equal(got, exact)
    err = (got.float() - ref.float()).abs()
    assert float(err.max()) <= 2 ** -7 * float(ref.float().abs().max())


def test_route_is_not_taken_under_autograd_or_in_f32(counted):
    """The -half_acc train step records the stem for its backward: it runs
    F.conv2d (JAX's kernel has no backward). An f32 eval forward does not
    take the bf16 route either."""
    args = route_args()
    state = steps.init_state(route_model(), args)
    out = steps.make_joint_train_step(args, 2, do_track=True)(
        state, route_batch(42), 2e-5)
    assert np.isfinite(float(out['cam_loss']))
    assert counted == []
    f32 = route_args(half_acc=False)
    steps.make_rgb_eval_step(f32, 2)(steps.init_state(route_model(), f32),
                                     route_batch(43))
    assert counted == []
    conv = route_model().conv1.to(torch.bfloat16)
    x = torch.zeros(1, 4, 33, 33, dtype=torch.bfloat16, requires_grad=True)
    conv(x).float().sum().backward()
    assert counted == [] and x.grad is not None


def test_state_dict_keys_are_unchanged():
    """StemConv keeps `weight`: the checkpoint keys are torchvision's."""
    model = route_model()
    assert isinstance(model.conv1, stem.StemConv)
    assert model.conv1.weight.shape == (64, 4, 7, 7)
    assert 'conv1.weight' in model.state_dict()
    assert not any(k.startswith('conv1.') and k != 'conv1.weight'
                   for k in model.state_dict())


@pytest.mark.cuda
def test_stem_kernel_on_the_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the stem kernel runs only on the '
                    'card')
    x, w = operands(9, 2, 4, 65)
    x, w = x.cuda(), w.cuda()
    out = stem.stem_conv(x, w, torch.float32)
    ref = stem.stem_conv_plain(x, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    mag = torch.as_tensor(magnitude(x.cpu(), w.cpu())).cuda()
    # tensor-core sums of the 196 exact products: within K 2^-23 of sum|terms|
    assert bool(((out - ref).abs() <= 196 * 2.0 ** -23 * mag).all())


def test_stem_packs_its_weight_once_per_version():
    """StemConv keeps pack_weight of its weight and makes it again only
    when the weight changes (an in-place update, a new dtype)."""
    conv = stem.StemConv(4).to(torch.bfloat16)
    w_hwio, packed = conv._packed()
    assert conv._packed()[1] is packed
    assert torch.equal(packed, stem.pack_weight(w_hwio))
    with torch.no_grad():
        conv.weight.add_(1.0)
    w_new, repacked = conv._packed()
    assert repacked is not packed
    assert torch.equal(w_new, conv.weight.detach().permute(2, 3, 1, 0))
    assert torch.equal(repacked, stem.pack_weight(w_new))


def test_stem_packs_each_eval_step_cast_anew():
    """The test epochs' eval step (steps._apply) casts the f32 masters to
    bf16 inside functional_call on every call: a fresh tensor each time,
    often at an address an earlier one had. With the masters changed
    between such forwards, the stem runs on the new weights each time: its
    output is the plain conv of the current bf16 weights, rounded to bf16,
    and differs from the last."""
    from pose_tpu_torch.train import steps

    conv = stem.StemConv(4)
    x, w = operands(23, 2, 4, 33)
    with torch.no_grad():
        conv.weight.copy_(w.float().permute(3, 2, 0, 1))
    outs, masters = [], []
    for _ in range(12):
        with torch.no_grad():
            outs.append(steps._apply(conv, (x,), False, torch.bfloat16))
            masters.append(conv.weight.detach().clone())
            conv.weight.mul_(-0.5)
    for out, w in zip(outs, masters):
        want = stem.stem_conv_plain(x, w.to(torch.bfloat16))
        assert torch.equal(out, want.to(torch.bfloat16).float())
    assert not any(torch.equal(a, b) for a, b in zip(outs, outs[1:]))


def test_stem_packs_a_new_tensor_on_reused_memory_anew():
    """A fresh weight tensor on the memory of the one packed last, at the
    same version (what the allocator gives when it reuses a freed cast),
    is packed anew: the second forward is the plain conv of its own
    weights."""
    conv = stem.StemConv(4).to(torch.bfloat16)
    x, w = operands(24, 1, 4, 33)
    mem = torch.empty((64, 4, 7, 7), dtype=torch.bfloat16)
    outs = []
    for sign in (1.0, -1.0):
        mem.copy_(sign * w.permute(3, 2, 0, 1))
        fresh = torch.empty(0, dtype=torch.bfloat16).set_(
            mem.untyped_storage(), 0, mem.shape, mem.stride())
        with torch.no_grad():
            out = torch.func.functional_call(conv, {'weight': fresh}, (x,))
        want = stem.stem_conv_plain(x, sign * w.permute(3, 2, 0, 1))
        assert torch.equal(out, want.to(torch.bfloat16))
        outs.append(out)
    assert not torch.equal(*outs)
