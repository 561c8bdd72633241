"""pose_tpu_torch's quantized conv on the CPU: `ops/int8_conv.quantized_conv`
routes to its plain chain, the plain chain equals the body of JAX's conv
interceptor (pose_tpu.quant.make_interceptor) on single convs, the packed
weight round-trips, and the planner that picks the CUDA kernel's tile
width and split-K covers every conv of the quantized ResNet-50 rgb
forward at batch 1, 8 and 64. The kernels themselves run only on the
card (tests/test_torch_cuda.py)."""

import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import flax.linen as fnn

from pose_tpu import quant as jquant

import chip_smoke
from pose_tpu_torch import quant, serve
from pose_tpu_torch.ops import int8_conv as i8

# (B, Cin, H, Cout, kernel, stride, padding, dilation): a 1x1, a strided
# 3x3, layer4's dilated 3x3, a stem and a head with a ragged Cout
CONVS = {
    '1x1': (2, 16, 9, 32, 1, 1, 0, 1),
    '3x3_s2': (2, 16, 9, 24, 3, 2, 1, 1),
    '3x3_dil2': (1, 32, 9, 16, 3, 1, 2, 2),
    'stem_cin4': (2, 4, 17, 64, 7, 2, 3, 1),
    'head_19': (1, 64, 5, 19, 3, 1, 1, 1),
}


@pytest.fixture
def x64():
    jax.config.update('jax_enable_x64', True)
    yield
    jax.config.update('jax_enable_x64', False)


def draw(case, seed, dtype):
    """x (B, H, W, Cin), an HWIO kernel, a bias and the calibrated absmax,
    drawn with numpy."""
    b, cin, h, cout, k, _, _, _ = CONVS[case]
    rng = np.random.RandomState(seed)
    x = (2.0 * rng.randn(b, h, h, cin)).astype(dtype)
    w = (0.1 * rng.randn(k, k, cin, cout)).astype(dtype)
    bias = rng.randn(cout).astype(dtype)
    return x, w, bias, float(np.abs(x).max()) * 0.8   # some codes clip


def port_conv(case, w, bias, absmax, acc_dtype, dtype):
    b, cin, h, cout, k, s, p, d = CONVS[case]
    conv = nn.Conv2d(cin, cout, k, s, p, d, bias=bias is not None).to(dtype)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(w).permute(3, 2, 0, 1))
        if bias is not None:
            conv.bias.copy_(torch.as_tensor(bias))
    return quant.QuantizedConv(conv, absmax, '', acc_dtype)


@pytest.mark.parametrize('with_bias', [False, True], ids=['nobias', 'bias'])
@pytest.mark.parametrize('acc', ['int32', 'bf16'])
@pytest.mark.parametrize('case', list(CONVS))
def test_quantized_conv_routes_to_plain_on_cpu(case, acc, with_bias):
    """On CPU tensors quantized_conv is quantized_conv_plain: the same
    bits, channels_last in x's dtype, and no kernel launch; a QuantizedConv
    forward is one call of it."""
    acc_dtype = torch.int32 if acc == 'int32' else torch.bfloat16
    x, w, bias, absmax = draw(case, 1, np.float32)
    qc = port_conv(case, w, bias if with_bias else None, absmax, acc_dtype,
                   torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.as_tensor(x).permute(0, 3, 1, 2).to(dtype)
        args = (qc.weight_packed, qc.geom, qc.x_scale, qc.scale,
                None if qc.bias is None else qc.bias.to(dtype), acc_dtype)
        before = (i8.quantized_conv.launches,
                  i8.quantized_conv.quantize_launches)
        got = i8.quantized_conv(xt, *args)
        ref = i8.quantized_conv_plain(xt, *args)
        assert (i8.quantized_conv.launches,
                i8.quantized_conv.quantize_launches) == before
        assert got.dtype == dtype
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           ref.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32))
    calls = []
    real = quant.quantized_conv
    try:
        quant.quantized_conv = lambda *a: calls.append(a) or real(*a)
        out = qc(torch.as_tensor(x).permute(0, 3, 1, 2))
    finally:
        quant.quantized_conv = real
    assert len(calls) == 1 and out.dtype == torch.float32


@pytest.mark.parametrize('with_bias', [False, True], ids=['nobias', 'bias'])
@pytest.mark.parametrize('acc', ['int32', 'bf16'])
@pytest.mark.parametrize('dtype', ['f32', 'f64'])
@pytest.mark.parametrize('case', list(CONVS))
def test_plain_chain_matches_jax_interceptor(x64, case, dtype, acc,
                                             with_bias):
    """quantized_conv_plain on the QuantizedConv's buffers against JAX's
    interceptor body on the same flax Conv (weights quantized from the
    same float kernel, the same calibrated absmax): equal bit for bit at
    f32 and f64 (JAX x64), with and without bias, int32 and bf16
    accumulators (K small enough that every sum is exact in f32, where
    both round it once to bf16)."""
    b, cin, h, cout, k, s, p, d = CONVS[case]
    npd = np.float64 if dtype == 'f64' else np.float32
    x, w, bias, absmax = draw(case, 2, npd)
    acc_t, acc_j = ((torch.int32, jnp.int32) if acc == 'int32'
                    else (torch.bfloat16, jnp.bfloat16))
    module = fnn.Conv(cout, (k, k), (s, s), ((p, p), (p, p)),
                      kernel_dilation=(d, d), use_bias=with_bias,
                      dtype=npd, param_dtype=npd)
    params = {'kernel': jnp.asarray(w)}
    if with_bias:
        params['bias'] = jnp.asarray(bias)
    fwd = jquant.quantized_call(
        lambda xin: module.apply({'params': params}, xin), {'': absmax},
        acc_dtype=acc_j)
    ref = np.asarray(fwd(jnp.asarray(x)))
    assert ref.dtype == npd

    tdtype = torch.float64 if dtype == 'f64' else torch.float32
    qc = port_conv(case, w, bias if with_bias else None, absmax, acc_t,
                   tdtype)
    got = i8.quantized_conv_plain(
        torch.as_tensor(x).permute(0, 3, 1, 2), qc.weight_packed, qc.geom,
        qc.x_scale, qc.scale, qc.bias, acc_t)
    assert got.dtype == tdtype
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize('shape', [(64, 4, 7, 7), (19, 2048, 3, 3),
                                   (304, 64, 3, 3), (2048, 1024, 1, 1),
                                   (1, 3, 7, 7)])
def test_pack_weight_round_trips(shape):
    """pack_weight's (Npad, Kpad) layout: rows of Cout padded to 64, K =
    KH KW Cin in (kh, kw, ci) order padded to 64 with zeros;
    unpack_weight inverts it."""
    cout, cin, kh, kw = shape
    rng = np.random.RandomState(cout + cin)
    w = torch.as_tensor(rng.randint(-127, 128, shape).astype(np.int8))
    geom = i8.Geometry(cout, cin, (kh, kw), (1, 1), (0, 0), (1, 1))
    packed = i8.pack_weight(w)
    k = kh * kw * cin
    assert packed.shape == (-(-cout // 64) * 64, -(-k // 64) * 64)
    assert not packed[cout:].any() and not packed[:, k:].any()
    row = cout - 1
    assert torch.equal(packed[row, :k], w[row].permute(1, 2, 0).reshape(-1))
    assert torch.equal(i8.unpack_weight(packed, geom), w)


def resnet50_conv_shapes():
    """(Cin, H, W, Geometry) of every conv of the quantized ResNet-50 rgb
    forward at 257^2 (skip=(): the stem and the heads too), from one
    forward on the meta device."""
    args = serve.default_args(extra_channel=True)
    with torch.device('meta'):
        model = serve.build_model(args, 'rgb')
    shapes = set()

    def record(mod, inputs):
        x = inputs[0]
        shapes.add((x.shape[1], x.shape[2], x.shape[3], i8.Geometry(
            mod.out_channels, mod.in_channels, tuple(mod.kernel_size),
            tuple(mod.stride), quant._padding(mod, ''),
            tuple(mod.dilation))))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, nn.Conv2d)]
    with torch.no_grad():
        model(torch.empty((1, 4, 257, 257), device='meta'))
    for h in hooks:
        h.remove()
    return sorted(shapes, key=str)


@pytest.mark.parametrize('batch', [1, 8, 64])
def test_planner_covers_every_resnet50_conv(batch):
    """At every distinct conv of the quantized ResNet-50 rgb forward (25:
    the stem, the trunk, both heads) and batch 1, 8 and 64, on the H100's
    132 SMs: a tile width the kernel has, a split that divides the K
    stages, keeps MIN_SPLIT_STEPS of them and fits a portable cluster (at
    most 8 blocks), and a grid within CUDA's limits; the split tiles'
    partials (128 x bn int32) fit the idle ring they are written to."""
    shapes = resnet50_conv_shapes()
    assert len(shapes) == 25
    splits = set()
    for cin, h, w, geom in shapes:
        oh, ow = geom.out_hw(h, w)
        m = batch * oh * ow
        kpad = -(-geom.k // 64) * 64
        p = i8.plan(m, geom.cout, kpad, i8.H100_SMS)
        total = -(-kpad // i8.BK)
        assert p.bn in i8.PLAN_NS
        assert p.split * p.steps == total
        assert 1 <= p.split <= i8.MAX_SPLIT == 8
        assert p.split == 1 or p.steps >= i8.MIN_SPLIT_STEPS
        assert p.tiles_m == -(-m // i8.BM) and p.tiles_m < 2 ** 31
        assert p.tiles_n == -(-geom.cout // p.bn) <= 65535
        assert p == i8.make_plan(m, geom.cout, kpad, p.bn, p.split)
        stages = 196608 // i8.BLOCKS_PER_SM[p.bn] // (i8.BM * i8.BK
                                                       + p.bn * i8.BK)
        assert i8.BM * p.bn * 4 <= stages * (i8.BM * i8.BK + p.bn * i8.BK)
        splits.add(p.split)
    if batch == 8:
        # layers 3-4 and the heads have fewer tiles than SMs at batch 8
        assert max(splits) > 1


def test_planner_splits_only_what_the_card_cannot_fill():
    """A conv with more output tiles than SMs runs unsplit; the 3x3 head
    of 2,048 channels at batch 8 (19 x 3 tiles of 128 x 128) splits, into
    at most a cluster's 8 blocks."""
    assert i8.plan(133128, 64, 256).split == 1
    head = i8.plan(8 * 17 * 17, 304, 18432)
    assert 1 < head.split <= 8 and 144 % head.split == 0


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('with_bias', [False, True])
def test_fused_work_is_its_formula(dtype, with_bias):
    """chip_smoke.int8_fused_work: x in its dtype read once, the int8
    weight once, the output in x's dtype written once, the 0-d scale, the
    (Cout,) f32 scales and the bias in x's dtype; 2 ops a multiply-add."""
    x = torch.zeros((8, 512, 17, 17), dtype=dtype)
    geom = i8.Geometry(512, 512, (3, 3), (1, 1), (2, 2), (2, 2))
    size = 2 if dtype == torch.bfloat16 else 4
    m, k = 8 * 17 * 17, 9 * 512
    want = (x.numel() * size + k * 512 + m * 512 * size + 4 + 4 * 512
            + with_bias * 512 * size)
    assert chip_smoke.int8_fused_work(x, geom, with_bias) == (
        want, 2 * m * k * 512)
    # the exact form: int8 in, int32 out
    assert chip_smoke.int8_work(x, geom)[:2] == (
        x.numel() + k * 512 + 4 * m * 512, 2 * m * k * 512)


def test_plain_bf16_accumulator_rounds_twice():
    """acc_dtype bf16 in the plain chain: each int32 sum goes to f32, then
    to bf16, as y.to(torch.bfloat16) does. A sum of 2^24 + 2^16 + 1
    rounds to 2^24 + 2^16 in f32 (ties to even), a bf16 tie that goes to
    2^24; rounded once it would be 2^24 + 2^17. The card's kernel is held
    to the same sums in tests/test_torch_cuda.py."""
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
    x = codes.reshape(1, cin, 1, 1)
    sums = i8.int8_conv(x.to(torch.int8), i8.pack_weight(w), geom)
    assert sums.flatten().tolist() == [2 ** 24 + 2 ** 16 + 1,
                                       -(2 ** 24 + 2 ** 16 + 1)]
    got = i8.quantized_conv(x, i8.pack_weight(w), geom, torch.tensor(1.0),
                            torch.ones((2, 1, 1)), None, torch.bfloat16)
    assert got.flatten().tolist() == [2.0 ** 24, -2.0 ** 24]
    # the bf16 nearest the sum (2^24 + 2^17, one bf16 step of 2^17 up) is
    # not what the chain gives: the test tells the two roundings apart
    t = 2 ** 24 + 2 ** 16 + 1
    assert abs(t - (2 ** 24 + 2 ** 17)) < abs(t - 2 ** 24)


def test_verbose_build_keeps_what_ptxas_printed(monkeypatch, tmp_path):
    """cuda_build.compile_sources(verbose=...) adds -Xptxas -v to those
    sources' nvcc and keeps what it printed (chip_smoke reports the int8
    kernels' registers and spills from it); the library is the same
    file name either way."""
    from pose_tpu_torch import cuda_build

    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    for name in ('a', 'b'):
        (csrc / f'{name}.cu').write_text(f'// {name}\n')
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text(
        '#!/bin/sh\n'
        'while [ $# -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then out="$2"; fi\n'
        '  if [ "$1" = "-v" ]; then verbose=1; fi\n'
        '  shift\n'
        'done\n'
        'touch "$out"\n'
        'if [ -n "$verbose" ]; then echo "ptxas info: Used 42 registers" >&2; '
        'fi\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv('NVCC', str(nvcc))
    monkeypatch.setattr(cuda_build, 'CSRC', str(csrc))
    monkeypatch.setattr(cuda_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(cuda_build, 'ptxas_logs', {})
    names = [cuda_build.library_path(n) for n in ('a', 'b')]
    cuda_build.compile_sources(['a', 'b'], verbose=('a',))
    assert 'Used 42 registers' in cuda_build.ptxas_logs['a']
    assert 'b' not in cuda_build.ptxas_logs
    assert [cuda_build.library_path(n) for n in ('a', 'b')] == names
    assert all(os.path.exists(p) for p in names)
