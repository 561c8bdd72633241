"""The yardstick's arithmetic: the card's peaks, the bytes and operations
each measured kernel must do (from shapes and from the run's own data),
and the model's convolution FLOPs for the whole-step shares of the peak.

Frozen copies of `chip_smoke.py`'s `split_warp_work`, `bn_work`,
`stem_work`, `finalize_work` and `bound_of`, and of the port's
`ops/warp.decompose_homography`, `row_map`, `col_map` (the geometry the
split warp's work is counted on), so that no later change to the program
moves the yardstick. Imports torch and numpy only.
"""

import numpy as np
import torch

# NVIDIA H100 SXM, data sheet, dense: HBM3 bandwidth, bf16 tensor cores,
# f32 outside the tensor cores (all at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


def bound_s(n_bytes, n_flops, flop_rate=F32_FLOP_PER_S):
    """The least seconds the card could take: the larger of the bytes over
    the memory rate and the operations over `flop_rate`."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / flop_rate)


# ------------------------------------------------------------ the model

def stage_schedule(stride):
    """(s2, s3, s4, d2, d3, d4): the stride and dilation of ResNet stages
    2-4 for an output stride (PoseResNet's schedule)."""
    s2 = int(np.minimum(np.maximum(np.log2(stride), 2), 3) - 1)
    s3 = int(np.minimum(np.maximum(np.log2(stride), 3), 4) - 2)
    s4 = int(np.minimum(np.maximum(np.log2(stride), 4), 5) - 3)
    d2 = 3 - s2
    d3 = (3 - s2) * (3 - s3)
    d4 = (3 - s2) * (3 - s3) * (3 - s4)
    return s2, s3, s4, d2, d3, d4


def _out(n, k, s, p, d=1):
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def model_layers(m):
    """The convolutions and BN layers of one image through a bottleneck
    PoseResNet described by the dict `m` (keys: layers, in_channels, side,
    stride, num_joints, depth, variant ('rgb', 'depth' or 'fusion'),
    joint_space). Returns (convs, bns): convs as (cin, cout, k, oh, ow),
    bns as (c, h, w, relu, res)."""
    convs, bns = [], []
    side = m['side']
    s2, s3, s4, _, _, _ = stage_schedule(m['stride'])

    def stem(cin):
        h = _out(side, 7, 2, 3)
        convs.append((cin, 64, 7, h, h))
        bns.append((64, h, h, True, False))
        return _out(h, 3, 2, 1)

    def stage(h, cin, planes, blocks, stride):
        for i in range(blocks):
            s = stride if i == 0 else 1
            ho = _out(h, 3, s, 1)
            convs.append((cin, planes, 1, h, h))
            bns.append((planes, h, h, True, False))
            convs.append((planes, planes, 3, ho, ho))
            bns.append((planes, ho, ho, True, False))
            convs.append((planes, planes * 4, 1, ho, ho))
            bns.append((planes * 4, ho, ho, True, True))
            if i == 0 and (s != 1 or cin != planes * 4):
                convs.append((cin, planes * 4, 1, ho, ho))
                bns.append((planes * 4, ho, ho, False, False))
            h, cin = ho, planes * 4
        return h, cin

    layers = m['layers']
    h = stem(m['in_channels'])
    h1, c = stage(h, 64, 64, layers[0], 1)
    h2, c = stage(h1, c, 128, layers[1], s2)
    if m['variant'] == 'fusion':
        g = stem(1)
        g, _ = stage(g, 64, 64, layers[0], 1)
        stage(g, 256, 128, layers[1], s2)
        convs.append((2 * c, c, 1, h2, h2))
        bns.append((c, h2, h2, True, False))
    h3, c = stage(h2, c, 256, layers[2], s3)
    h4, c = stage(h3, c, 512, layers[3], s4)
    convs.append((c, m['depth'] * m['num_joints'], 3, h4, h4))
    if m['variant'] == 'rgb' and m.get('joint_space'):
        convs.append((c, m['num_joints'], 3, h4, h4))
    return convs, bns


def conv_flops(convs):
    """2 operations per multiply-add of every convolution of one image."""
    return sum(2 * cin * cout * k * k * oh * ow
               for cin, cout, k, oh, ow in convs)


def forward_flops(m):
    return conv_flops(model_layers(m)[0])


# ------------------------------------------------------------ fused BN

def bn_work(m, c, size, relu, res):
    """Bytes each fused-BN kernel must move (each input read once, each
    output written once; partials not counted) and the f32 operations it
    does, at (M, C) with `size`-byte activations. {kernel: (bytes,
    flops)}."""
    mc = m * c
    return {
        'fused_bn_stats': (mc * size + 2 * c * 4 + 7 * c * 4, 3 * mc),
        'fused_bn_apply': (mc * size * (2 + res) + 2 * c * 4,
                           mc * (2 + res + relu)),
        'fused_bn_bwd_sums': (mc * size * (2 + relu) + 10 * c * 4,
                              mc * (4 + relu)),
        'fused_bn_dx': (mc * size * (3 + relu + res) + 3 * c * 4,
                        mc * (4 + relu)),
    }


def finalize_work(c, g_size, bwd):
    """Bytes and f32 operations of a finalize on (2, C) sums."""
    if bwd:
        return 7 * c * 4 + c * g_size + 5 * c * 4, 12 * c
    return 2 * c * 4 + 2 * c * g_size + 5 * c * 4, 8 * c


def bn_bound_s(bns, batch, size, backward):
    """The least seconds of every fused-BN launch of one forward (and,
    with `backward`, its backward) over `batch` images: each kernel's
    bound summed, the finalizes with them."""
    total = 0.0
    kernels = (('fused_bn_stats', 'fused_bn_apply')
               + (('fused_bn_bwd_sums', 'fused_bn_dx') if backward else ()))
    for c, h, w, relu, res in bns:
        work = bn_work(batch * h * w, c, size, relu, res)
        total += sum(bound_s(*work[k]) for k in kernels)
        total += bound_s(*finalize_work(c, 4, False))
        if backward:
            total += bound_s(*finalize_work(c, 4, True))
    return total


# ------------------------------------------------------------ stem conv

def stem_work(b, cin, h, w, out_size):
    """Bytes (bf16 input and weights read once, NHWC output written once)
    and operations (2 per multiply-add) of the 7x7 stride-2 stem conv."""
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    n_bytes = b * cin * h * w * 2 + 49 * cin * 64 * 2 + b * oh * ow * 64 * out_size
    return n_bytes, 2 * b * oh * ow * 64 * 49 * cin


# ------------------------------------------------------------ split warp

def decompose_homography(homographies, out_shape, m):
    """H = A o R: A maps [0, m)^2 onto the bounding box of H([0, out)^2)
    plus a 1px margin, R = A^-1 H. Returns (R, scale) with scale rows
    (step, start) for y then x."""
    h = homographies
    out_h, out_w = out_shape
    corners = torch.tensor(
        [[0.0, 0.0, 1.0], [out_w - 1.0, 0.0, 1.0],
         [0.0, out_h - 1.0, 1.0], [out_w - 1.0, out_h - 1.0, 1.0]],
        dtype=h.dtype, device=h.device)
    p = torch.einsum('...ij,cj->...ci', h, corners)
    xy = p[..., :2] / p[..., 2:3]
    lo = torch.amin(xy, dim=-2) - 1.0
    hi = torch.amax(xy, dim=-2) + 1.0
    step = (hi - lo) / (m - 1.0)
    zeros = torch.zeros_like(step[..., 0])
    ones = torch.ones_like(step[..., 0])
    ainv = torch.stack([
        torch.stack([1.0 / step[..., 0], zeros, -lo[..., 0] / step[..., 0]],
                    -1),
        torch.stack([zeros, 1.0 / step[..., 1], -lo[..., 1] / step[..., 1]],
                    -1),
        torch.stack([zeros, zeros, ones], -1)], -2)
    residual = torch.einsum('...ij,...jk->...ik', ainv, h)
    scale = torch.stack([
        torch.stack([step[..., 1], lo[..., 1]], -1),
        torch.stack([step[..., 0], lo[..., 0]], -1)], -2)
    return residual, scale


def split_m(out_side):
    """The split warp's intermediate side for an output side."""
    return max((out_side // 8) * 8, 16)


def _nonfinite_to(x, fill=-1e9):
    return torch.where(torch.isfinite(x), x, torch.full_like(x, fill))


def row_map(homographies, out_h, src_w):
    """Pass 1's source row Y(v, x_s) of a two-pass warp, (B, out_h,
    src_w)."""
    b = homographies.shape[0]
    dev = homographies.device
    h = homographies.to(torch.float32).reshape(b, 9)
    h00, h01, h02, h10, h11, h12, h20, h21, h22 = (
        h[:, k, None, None] for k in range(9))
    v = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(src_w, dtype=torch.float32, device=dev)[None, None, :]
    u_of = (xs * (h21 * v + h22) - h01 * v - h02) / (h00 - h20 * xs)
    w_h = h20 * u_of + h21 * v + h22
    return _nonfinite_to((h10 * u_of + h11 * v + h12) / w_h)


def col_map(homographies, out_shape):
    """Pass 2's source column X(u, v), (B, out_h, out_w)."""
    b = homographies.shape[0]
    dev = homographies.device
    out_h, out_w = out_shape
    h = homographies.to(torch.float32).reshape(b, 9)
    h00, h01, h02, _, _, _, h20, h21, h22 = (
        h[:, k, None, None] for k in range(9))
    uu = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    vv = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    return _nonfinite_to((h00 * uu + h01 * vv + h02) / (h20 * uu + h21 * vv
                                                        + h22))


def _taps(t, n, lim):
    f0 = torch.floor(t)
    idx = torch.stack([f0, f0 + 1.0], -1)
    w = torch.stack([1.0 - (t - f0), t - f0], -1)
    ok = ((t > -1.0) & (t < n))[..., None] & (idx >= 0) & (idx < n) \
        & (idx <= lim[..., None]) & (w > 0)
    return torch.where(ok, idx, torch.full_like(idx, n)).long()


def _mark(shape, n, idx):
    hit = torch.zeros((idx.shape[0], n + 1) + shape, dtype=torch.float32,
                      device=idx.device)
    return hit.scatter_(1, idx, 1.0)[:, :n] > 0


def _two_pass_reads(homs, src_hw, out_hw, extents):
    b = homs.shape[0]
    src_h, src_w = src_hw
    out_h = out_hw[0]
    ext = extents.reshape(b, 2).to(torch.float32)
    lim_y = (ext[:, 0] - 1.0)[:, None, None]
    lim_x = (ext[:, 1] - 1.0)[:, None, None]
    xi = _taps(col_map(homs, out_hw), src_w, lim_x)
    used_vx = _mark((out_h,), src_w,
                    xi.reshape(b, out_h, -1).transpose(1, 2)).transpose(1, 2)
    yi = _taps(row_map(homs, out_h, src_w), src_h, lim_y)
    yi = torch.where(used_vx[..., None], yi, torch.full_like(yi, src_h))
    read = _mark((src_w,), src_h, yi.permute(0, 1, 3, 2).reshape(b, -1,
                                                                 src_w))
    return read, used_vx


def split_warp_work(canvases, homographies, extents, out_side):
    """What the split warp must do for this batch: the canvas pixels under
    the stage-A taps of the intermediate pixels that stage B samples with
    nonzero weight (each read once), the (B, 15) scalars and the f32 crops
    (each written once), and 2 f32 operations per tap and channel of its
    separable 2-tap form. Returns (bytes, flops). Run in blocks of rows by
    the caller where memory is short."""
    b, src_h, src_w, n_ch = canvases.shape
    out_hw = (out_side, out_side)
    m = split_m(out_side)
    dev = canvases.device
    residual, scale = decompose_homography(
        homographies.to(torch.float32), out_hw, m)
    full = torch.full((b, 2), float(m), device=dev)
    inter, used_vx = _two_pass_reads(residual, (m, m), out_hw, full)
    p = torch.arange(m, dtype=torch.float32, device=dev)[None]
    ext = extents.reshape(b, 2).to(torch.float32)
    rows = _taps(scale[:, 0, 1, None] + p * scale[:, 0, 0, None], src_h,
                 ext[:, :1] - 1.0)
    cols = _taps(scale[:, 1, 1, None] + p * scale[:, 1, 0, None], src_w,
                 ext[:, 1:] - 1.0)
    row_of = _mark((m,), src_h, rows.transpose(1, 2)).float()
    col_of = _mark((m,), src_w, cols.transpose(1, 2)).float()
    t1 = (inter.float() @ col_of.transpose(1, 2)) > 0
    read = (row_of @ t1.float()) > 0
    n_bytes = (int(read.sum()) * n_ch * canvases.element_size() + b * 15 * 4
               + b * n_ch * out_side * out_side * 4)
    n_flops = 4 * n_ch * (int(t1.sum()) + int(inter.sum())
                          + int(used_vx.sum()) + b * out_side * out_side)
    return n_bytes, n_flops


def split_warp_bound_s(canvases, homographies, extents, out_side, block=32):
    """bound_s of split_warp_work over a batch, counted in blocks of
    `block` rows."""
    n_bytes = n_flops = 0
    for i in range(0, canvases.shape[0], block):
        nb, nf = split_warp_work(canvases[i:i + block],
                                 homographies[i:i + block],
                                 extents[i:i + block], out_side)
        n_bytes += nb
        n_flops += nf
    return bound_s(n_bytes, n_flops)
