"""The frozen yardstick: bytes and operations at known shapes."""

import torch

from port_bench import work

RESNET50 = dict(variant='rgb', layers=[3, 4, 6, 3], in_channels=3,
                side=224, stride=32, num_joints=19, depth=16,
                joint_space=False)


def test_bn_work_counts_each_byte_once():
    w = work.bn_work(m=1000, c=64, size=2, relu=True, res=True)
    assert w['fused_bn_stats'] == (1000 * 64 * 2 + 9 * 64 * 4, 3 * 64000)
    assert w['fused_bn_apply'] == (64000 * 2 * 3 + 2 * 64 * 4, 64000 * 4)
    assert w['fused_bn_bwd_sums'] == (64000 * 2 * 3 + 10 * 64 * 4,
                                      64000 * 5)
    assert w['fused_bn_dx'] == (64000 * 2 * 5 + 3 * 64 * 4, 64000 * 5)


def test_stem_work():
    n_bytes, flops = work.stem_work(8, 3, 257, 257, 2)
    assert flops == 2 * 8 * 129 * 129 * 64 * 49 * 3
    assert n_bytes == 8 * 3 * 257 * 257 * 2 + 49 * 3 * 64 * 2 \
        + 8 * 129 * 129 * 64 * 2


def test_resnet50_trunk_macs_match_the_published_count():
    # torchvision resnet50 at 224^2: 4.0892e9 multiply-adds, of which the
    # fc layer is 2048 x 1000; the trunk alone is the rest
    convs, bns = work.model_layers(RESNET50)
    trunk = work.conv_flops(convs[:-1]) / 2
    assert abs(trunk - (4.0892e9 - 2.048e6)) / 4.0892e9 < 0.01
    assert len(bns) == 53


def test_stride_16_dilates_the_last_stage():
    m = dict(RESNET50, side=257, stride=16)
    convs, _ = work.model_layers(m)
    assert convs[-1][3:] == (17, 17)
    assert work.stage_schedule(16) == (2, 2, 1, 1, 1, 2)


def test_fusion_teacher_has_two_stems_and_a_fusion_block():
    m = dict(RESNET50, variant='fusion', side=257, stride=16)
    convs, bns = work.model_layers(m)
    assert sum(c[2] == 7 for c in convs) == 2
    assert len(bns) == 53 + 1 + 10 + 1 + 12 + 1   # + stem, l5, l6, fusion


def test_split_warp_work_is_bounded_by_its_canvas_and_crops():
    gen = torch.Generator().manual_seed(0)
    b, side = 2, 65
    canvases = torch.randint(0, 256, (b, 128, 128, 3), generator=gen,
                             dtype=torch.uint8)
    s = 96.0 / side
    homs = torch.tensor([[s, 0.0, 10.0], [0.0, s, 12.0], [0.0, 0.0, 1.0]]
                        ).expand(b, 3, 3).contiguous()
    ext = torch.full((b, 2), 128, dtype=torch.int32)
    n_bytes, flops = work.split_warp_work(canvases, homs, ext, side)
    out = b * 3 * side * side * 4
    assert out < n_bytes <= out + b * 128 * 128 * 3 + b * 60
    # the canvas pixels under a 96-pixel window, each read once
    assert n_bytes - out - b * 60 <= b * 98 * 98 * 3
    assert flops > 4 * 3 * b * side * side
    assert work.split_warp_bound_s(canvases, homs, ext, side, block=1) == \
        work.bound_s(n_bytes, flops)
