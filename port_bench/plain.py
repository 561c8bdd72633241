"""Plain PyTorch of what the measured steps compute, the reference that
decides `correct`: PoseResNet-50's trunk and heads as functions of a
state dict, train- and eval-mode BatchNorm, the volumetric and planar
soft-argmax, the least-squares root, the masked SmoothL1, the
distillation loss, the clip-decay-Adam update, and the input path (the
split warp's plain form, the colour chain, the bbox mask, the depth
enhancement).

Written from the published descriptions and the reference repository's
semantics; it imports nothing of the program and no JAX. Float32 with
TF32 off (`no_tf32`). `q`, where a function takes it, rounds every
convolution's operands (a low-precision control); None is float32.
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import work

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEV = (0.229, 0.224, 0.225)
BN_EPS = 1e-5


def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def fp8_e4m3(t):
    """t rounded to float8 e4m3 with one scale per tensor (amax to 448),
    back in t's dtype; the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    r = (t.detach() * s).to(torch.float8_e4m3fn).to(t.dtype) / s
    return t + (r - t.detach())


# ------------------------------------------------------------ the model

def conv(p, name, x, stride=1, padding=0, dilation=1, q=None):
    w, b = p[name + '.weight'], p.get(name + '.bias')
    if q is not None:
        x, w = q(x), q(w)
    return F.conv2d(x, w, b, stride, padding, dilation)


def batch_norm(p, name, x, train, relu=False, res=None, stats=None):
    """y = gamma (x - mean) / sqrt(var + eps) + beta [+ res], ReLU'd; the
    batch's mean and biased variance in train mode (kept in `stats` by
    name where given), the running statistics otherwise."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[name + '.running_mean'], p[name + '.running_var']
    scale = p[name + '.weight'] * torch.rsqrt(var + BN_EPS)
    y = (x - mean[None, :, None, None]) * scale[None, :, None, None] \
        + p[name + '.bias'][None, :, None, None]
    if res is not None:
        y = y + res
    return torch.relu(y) if relu else y


def _block(p, name, x, stride, dilation, train, q, stats):
    if name + '.downsample.0.weight' in p:
        res = batch_norm(p, name + '.downsample.1',
                         conv(p, name + '.downsample.0', x, stride, q=q),
                         train, stats=stats)
    else:
        res = x
    y = batch_norm(p, name + '.bn1', conv(p, name + '.conv1', x, q=q),
                   train, relu=True, stats=stats)
    y = batch_norm(p, name + '.bn2',
                   conv(p, name + '.conv2', y, stride, dilation, dilation,
                        q=q), train, relu=True, stats=stats)
    return batch_norm(p, name + '.bn3', conv(p, name + '.conv3', y, q=q),
                      train, relu=True, res=res, stats=stats)


def _run(fn, x, ckpt):
    return checkpoint(fn, x, use_reentrant=False) if ckpt else fn(x)


def _stem(p, conv_name, bn_name, x, train, q, ckpt, stats):
    def fn(t):
        t = batch_norm(p, bn_name, conv(p, conv_name, t, 2, 3, q=q), train,
                       relu=True, stats=stats)
        return F.max_pool2d(t, 3, 2, 1)
    return _run(fn, x, ckpt)


def _stage(p, name, x, blocks, stride, dilation, train, q, ckpt, stats):
    for i in range(blocks):
        s, d = (stride, dilation) if i == 0 else (1, 1)
        x = _run(lambda t, n=f'{name}.{i}', s=s, d=d:
                 _block(p, n, t, s, d, train, q, stats), x, ckpt)
    return x


def trunk(p, m, x, y=None, train=True, q=None, ckpt=False, stats=None):
    """The bottleneck trunk of `m` (work.model_layers' dict) on NCHW x
    (and, for the fusion variant, the depth stream y): the stage-4
    features. `ckpt` recomputes each block in the backward (activation
    checkpointing), so that a large batch fits."""
    s2, s3, s4, d2, d3, d4 = work.stage_schedule(m['stride'])
    layers = m['layers']
    kw = dict(train=train, q=q, ckpt=ckpt, stats=stats)
    h = _stem(p, 'conv1', 'bn1', x, **kw)
    h = _stage(p, 'layer1', h, layers[0], 1, 1, **kw)
    h = _stage(p, 'layer2', h, layers[1], s2, d2, **kw)
    if m['variant'] == 'fusion':
        g = _stem(p, 'conv2', 'bn2', y, **kw)
        g = _stage(p, 'layer5', g, layers[0], 1, 1, **kw)
        g = _stage(p, 'layer6', g, layers[1], s2, d2, **kw)
        h = batch_norm(p, 'fusion.bn',
                       conv(p, 'fusion.conv', torch.cat([h, g], 1), q=q),
                       train, relu=True, stats=stats)
    h = _stage(p, 'layer3', h, layers[2], s3, d3, **kw)
    return _stage(p, 'layer4', h, layers[3], s4, d4, **kw)


def heads(p, m, n, q=None):
    """rgb: (cam, mat) or cam; other variants: (cam, tap)."""
    if m['variant'] == 'rgb':
        cam = conv(p, 'cam_regressor', n, padding=1, q=q)
        if m.get('joint_space'):
            return cam, conv(p, 'mat_regressor', n, padding=1, q=q)
        return cam
    return conv(p, 'regressor', n, padding=1, q=q), n


# ------------------------------------------------------------ decoding

def heatmap3d(feat, depth, joints):
    b, _, h, w = feat.shape
    vol = feat.reshape(b, depth, joints, h, w).permute(0, 2, 3, 4, 1)
    return torch.softmax(vol.reshape(b, joints, -1), 2).reshape(
        b, joints, h, w, depth)


def decode3d(hm, depth_range):
    def axis(heat):
        grid = torch.linspace(0.0, 2.0, heat.shape[-1], dtype=heat.dtype,
                              device=heat.device)
        return (grid * heat).sum(2)
    return torch.stack((axis(hm.sum((2, 4))), axis(hm.sum((3, 4))),
                        axis(hm.sum((2, 3)))), 2) * depth_range


def decode2d(feat, joints, side):
    b, _, h, w = feat.shape
    hm = torch.softmax(feat.reshape(b, joints, -1), 2).reshape(b, joints, h,
                                                               w)

    def axis(heat):
        grid = torch.linspace(0.0, 1.0, heat.shape[-1], dtype=heat.dtype,
                              device=heat.device)
        return (grid * heat).sum(-1)
    return torch.stack((axis(hm.sum(2)), axis(hm.sum(3))), 2) * side


def relative_cam(cam_feat, m, depth_range, key):
    rel = decode3d(heatmap3d(cam_feat, m['depth'], m['num_joints']),
                   depth_range)
    return rel - rel[:, key:key + 1]


def recon_root(spec_mat, relat, intrinsics):
    """Least-squares root: per joint [I2 | -x~] r = x~ z - xy."""
    b, j = spec_mat.shape[:2]
    homog = torch.cat([spec_mat, torch.ones_like(spec_mat[..., :1])], -1)
    norm = (homog @ torch.linalg.inv(intrinsics).transpose(1, 2))[..., :2]
    eye = torch.eye(2, dtype=spec_mat.dtype, device=spec_mat.device)
    a = torch.cat([eye.repeat(j, 1).expand(b, 2 * j, 2),
                   -norm.reshape(b, -1, 1)], -1)
    rhs = (norm * relat[..., 2:] - relat[..., :2]).reshape(b, -1, 1)
    at = a.transpose(1, 2)
    root = torch.linalg.solve(at @ a, at @ rhs)
    return relat + root.transpose(1, 2)


def smooth_l1(pred, target):
    d = pred - target
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def masked_mean(pred, target, valid):
    w = valid.to(pred.dtype)[..., None]
    denom = torch.clamp(valid.to(pred.dtype).sum() * pred.shape[-1], min=1.0)
    return (smooth_l1(pred, target) * w).sum() / denom


def distill_loss(teach, last, atten):
    """Mean over the batch of the L2 norm of (teacher - student) under the
    attention map (NHWC (B, H, W, 1))."""
    diff = (teach - last) * atten.permute(0, 3, 1, 2)
    return diff.reshape(diff.shape[0], -1).norm(dim=1).mean()


# ------------------------------------------------------------ optimizer

class Adam:
    """clip by global norm (no epsilon), weight decay added to the
    gradient, Adam (0.9, 0.999, 1e-8, bias-corrected), p -= lr * update.
    `first_grads` keeps the first step's gradient as Adam receives it."""

    def __init__(self, params, max_norm, weight_decay):
        self.params = params
        self.max_norm, self.wd = max_norm, weight_decay
        self.mu = [torch.zeros_like(t) for t in params]
        self.nu = [torch.zeros_like(t) for t in params]
        self.count = 0
        self.first_grads = None

    @torch.no_grad()
    def step(self, grads, lr):
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        factor = 1.0 if norm < self.max_norm else self.max_norm / norm
        grads = [g * factor + self.wd * p for g, p in zip(grads,
                                                           self.params)]
        if self.first_grads is None:
            self.first_grads = [g.clone() for g in grads]
        self.count += 1
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(0.9).add_(g, alpha=0.1)
            nu.mul_(0.999).addcmul_(g, g, value=0.001)
            mu_hat = mu / (1 - 0.9 ** self.count)
            nu_hat = nu / (1 - 0.999 ** self.count)
            p.sub_(lr * mu_hat / (nu_hat.sqrt() + 1e-8))


# ------------------------------------------------------------ the input

def _tri(d):
    return torch.clamp(1.0 - d.abs(), min=0.0)


def scale_resample(images, scale, extents, m):
    """Axis-aligned bilinear resample of (B, H, W, C) canvases onto a
    planar (B, C, m, m) f32 grid, zero weight at or beyond each extent."""
    b, src_h, src_w, c = images.shape
    dev = images.device
    eh = extents[:, 0].float()[:, None, None]
    ew = extents[:, 1].float()[:, None, None]
    pos = torch.arange(m, dtype=torch.float32, device=dev)[None, :, None]
    sy = torch.arange(src_h, dtype=torch.float32, device=dev)[None, None]
    sx = torch.arange(src_w, dtype=torch.float32, device=dev)[None, None]
    w1 = _tri(scale[:, 0, 1, None, None] + pos * scale[:, 0, 0, None, None]
              - sy) * (sy <= eh - 1.0)
    w2 = _tri(scale[:, 1, 1, None, None] + pos * scale[:, 1, 0, None, None]
              - sx) * (sx <= ew - 1.0)
    t1 = torch.bmm(w1, images.float().reshape(b, src_h, src_w * c))
    t1 = t1.reshape(b, m, src_w, c).permute(0, 3, 1, 2)
    return torch.matmul(t1, w2.transpose(1, 2)[:, None])


def two_pass_warp(planar, homs, out_side):
    """The exact two-pass perspective warp of planar (B, C, H, W) images
    through out->src homographies, over the whole source."""
    b, c, src_h, src_w = planar.shape
    dev = planar.device
    y_map = work.row_map(homs, out_side, src_w)
    sy = torch.arange(src_h, dtype=torch.float32, device=dev)[None, None, :,
                                                              None]
    inter = torch.einsum('bcyx,bvyx->bcvx', planar,
                         _tri(y_map[:, :, None, :] - sy))
    x_map = work.col_map(homs, (out_side, out_side))
    sx = torch.arange(src_w, dtype=torch.float32, device=dev)[None, None, :,
                                                              None]
    return torch.einsum('bcvx,bvxu->bcvu', inter,
                        _tri(x_map[:, :, None, :] - sx))


def split_warp(canvases, homs, extents, out_side, chunk=8):
    """(B, H, W, C) canvases (uint8: the 1/255 on the intermediate) ->
    planar (B, C, out, out) f32 crops: stage A onto the (m, m) grid of
    the homography's bounding box, stage B the residual homography."""
    m = work.split_m(out_side)
    post = 1.0 / 255.0 if canvases.dtype == torch.uint8 else 1.0
    outs = []
    for i in range(0, canvases.shape[0], chunk):
        residual, scale = work.decompose_homography(
            homs[i:i + chunk].float(), (out_side, out_side), m)
        inter = scale_resample(canvases[i:i + chunk], scale,
                               extents[i:i + chunk].reshape(-1, 2), m) * post
        outs.append(two_pass_warp(inter, residual, out_side))
    return torch.cat(outs)


def _hsv(r, g, b):
    v = torch.maximum(torch.maximum(r, g), b)
    delta = v - torch.minimum(torch.minimum(r, g), b)
    safe = torch.where(delta == 0, 1.0, delta)
    h = torch.where(v == r, 60.0 * (g - b) / safe,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                                240.0 + 60.0 * (r - g) / safe))
    h = torch.where(delta == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h)
    s = torch.where(v == 0, 0.0, delta / torch.where(v == 0, 1.0, v))
    return h, s, v


def _rgb(h, s, v):
    h = h / 60.0
    i = torch.floor(h)
    f = h - i
    p, qq, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    table = ((v, qq, p, p, t, v), (t, v, v, qq, p, p), (p, p, t, v, v, qq))
    out = []
    for row in table:
        c = torch.zeros_like(v)
        for k in reversed(range(6)):
            c = torch.where(i == k, row[k], c)
        out.append(c)
    return out


def colour(planar, draws):
    """Brightness, contrast (about 0.5), hue shift (degrees, HSV) and
    saturation scale per image, then truncation to the uint8 lattice, on
    planar (B, 3, H, W) values in [0, 1] with (B, 4) draws."""
    bri, con, hue, sat = (draws[:, k, None, None] for k in range(4))
    r, g, b = (torch.clamp(planar[:, k] + bri, 0, 1) for k in range(3))
    r, g, b = (torch.clamp((c - 0.5) * con + 0.5, 0, 1) for c in (r, g, b))
    h, s, v = _hsv(r, g, b)
    h = h + hue
    h = torch.where(h < 0, h + 360.0, h)
    h = torch.where(h >= 360.0, h - 360.0, h)
    s = torch.clamp(s * sat, 0, 1)
    return torch.stack([torch.floor(torch.clamp(c, 0, 1) * 255.0) / 255.0
                        for c in _rgb(h, s, v)], 1)


def normalize(planar):
    mean = torch.tensor(IMAGENET_MEAN, device=planar.device)[:, None, None]
    dev = torch.tensor(IMAGENET_DEV, device=planar.device)[:, None, None]
    return (planar - mean) / dev


def bbox_mask(quads, side):
    """{0, 1} (B, side, side, 1): inside the convex quad (x, y) corners."""
    kw = dict(dtype=torch.float32, device=quads.device)
    yy = torch.arange(side, **kw)[:, None]
    xx = torch.arange(side, **kw)[None, :]
    a = quads[:, :, None, None, :]
    b = quads.roll(-1, dims=1)[:, :, None, None, :]
    cross = ((b[..., 0] - a[..., 0]) * (yy - a[..., 1])
             - (b[..., 1] - a[..., 1]) * (xx - a[..., 0]))
    inside = (cross >= 0).all(1) | (cross <= 0).all(1)
    return inside.float()[..., None]


def colour_input(canvases, homs, extents, draws, quads, side, extra_channel):
    """The training colour input, NHWC: warp, clip, colour chain, ImageNet
    normalisation, and the bbox mask as a 4th channel."""
    crops = torch.clamp(split_warp(canvases, homs, extents, side), 0.0, 1.0)
    crops = normalize(colour(crops, draws)).permute(0, 2, 3, 1)
    if extra_channel:
        crops = torch.cat([crops, bbox_mask(quads, side)], -1)
    return crops


def depth_input(canvases, homs, extents, thresh, side):
    """Raw depth (metres) -> the enhanced depth input, NHWC (B, S, S, 1):
    the split warp in f32, then d / (10 / 255) / 3 (no -nexponent)."""
    crops = split_warp(canvases, homs, extents, side).permute(0, 2, 3, 1)
    del thresh      # the validity veil only enters under -nexponent
    return crops / (10.0 / 255.0) / 3.0


def param_norms(tensors):
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def median(values):
    s = sorted(values)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def leaf_gaps(got, want, keep=None):
    """Per leaf, |got - want| / max(want, the median of want), where got
    and want are per-leaf norms; `keep` masks the leaves compared."""
    floor = median(want)
    return [abs(got[i] - want[i]) / max(want[i], floor, 1e-30)
            for i in range(len(want)) if keep is None or keep[i]]


def relative_gap(got, want):
    return abs(got - want) / max(abs(want), 1e-30)

