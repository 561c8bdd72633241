"""The one generator of every traffic mix: it reads a mix's parameters
(`port_bench/traffic/<name>.json`) and makes its inputs from the seed, on
the device, at set-up.

Training batches are the JAX bench's (bench.py): uint8 canvases of random
pixels, their true extents smaller than the canvas and zero beyond (as
the loader packs variable-size frames), crop homographies with random
placement, zoom in [0.9, 1/0.9], a small rotation and perspective (the
out->src map of a ~1.5x side crop), ground truth about 3 m deep projected
with seeded crop intrinsics, bbox quads around it, and the colour
chain's draws. The distillation's batches add raw Kinect-sized depth
canvases (metres) with their own crop homographies and the attention
maps of the ground truth's 2D positions. Serving requests are normalised
colour crops, and arrivals a Poisson process whose gaps are one fixed set
for every seed (from seed 0), put in the seed's order.

Host arrays (the homographies, which the program's gate reads on the
host) come from numpy; device arrays from a torch.Generator on the card,
in a few large calls.
"""

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEV = (0.229, 0.224, 0.225)


def rngs(seed, stream):
    """(numpy Generator, seed of a torch Generator) for a named stream of
    `seed`: the same seed gives the same inputs, and any whole number up to
    2**64 may be a seed."""
    seq = np.random.SeedSequence([int(seed) % 2 ** 63, int(seed) >> 63,
                                  sum(map(ord, stream))])
    a, b = seq.generate_state(2, np.uint64)
    return np.random.default_rng(int(a)), int(b) % 2 ** 63


def crop_homographies(rng, b, canvas_hw, side):
    """(b, 3, 3) f32 out->src homographies (bench.py's realistic_homs,
    vectorised)."""
    zoom = rng.uniform(0.9, 1.0 / 0.9, b)
    s = 384.0 / side / zoom
    th = rng.uniform(-0.05, 0.05, b)
    c, sn = np.cos(th), np.sin(th)
    span = s * side
    tx = rng.uniform(0, 1, b) * np.maximum(canvas_hw[1] - span, 1)
    ty = rng.uniform(0, 1, b) * np.maximum(canvas_hw[0] - span, 1)
    homs = np.zeros((b, 3, 3), np.float32)
    homs[:, 0] = np.stack([s * c, -s * sn, tx], -1)
    homs[:, 1] = np.stack([s * sn, s * c, ty], -1)
    homs[:, 2] = np.stack([rng.uniform(-1, 1, b) * 2e-5,
                           rng.uniform(-1, 1, b) * 2e-5, np.ones(b)], -1)
    return homs


def ground_truth(rng, b, joints, side, key):
    """Joints about 3 m deep, seeded crop intrinsics, their projections,
    bbox quads 20 px around them, ~90 % valid with the key joint always."""
    root = np.stack([rng.uniform(-200, 200, b), rng.uniform(-200, 200, b),
                     rng.uniform(2800, 3200, b)], -1)
    cam = root[:, None] + np.concatenate(
        [rng.uniform(-400, 400, (b, joints, 2)),
         rng.uniform(-200, 200, (b, joints, 1))], -1)
    f = rng.uniform(450, 550, b)
    intr = np.zeros((b, 3, 3))
    intr[:, 0, 0] = intr[:, 1, 1] = f
    intr[:, :2, 2] = side / 2
    intr[:, 2, 2] = 1
    mat = (cam[..., :2] / cam[..., 2:]) * f[:, None, None] + side / 2
    lo = np.clip(mat.min(1) - 20, 0, side - 1)
    hi = np.clip(mat.max(1) + 20, 0, side - 1)
    quads = np.stack([lo, np.stack([hi[:, 0], lo[:, 1]], -1), hi,
                      np.stack([lo[:, 0], hi[:, 1]], -1)], 1)
    valid = rng.random((b, joints)) > 0.1
    valid[:, key] = True
    return dict(true_cam=cam.astype(np.float32),
                true_mat=mat.astype(np.float32), true_val=valid,
                intrinsics=intr.astype(np.float32),
                quads=quads.astype(np.float32), focal=f)


def attention_maps(side, stride, mat):
    """(B, S, S, 1) f32: the sum of unit Gaussians (variance 2.5 output
    cells) at each joint's 2D position on the output grid, normalised to
    a maximum of 1 (the reference's -attention map)."""
    out = (side - 1) // stride + 1
    cx, cy = np.meshgrid(np.arange(out), np.arange(out))
    dx = cx[None, :, :, None] - mat[:, None, None, :, 0] / (side / out)
    dy = cy[None, :, :, None] - mat[:, None, None, :, 1] / (side / out)
    radial = np.exp(-(dx ** 2 + dy ** 2) / 5.0).sum(-1)
    radial = radial / radial.max((1, 2), keepdims=True)
    return radial[..., None].astype(np.float32)


def _canvases(gen, b, hw, ch, lo_share, device):
    """uint8 (ch 3) or raw-depth f32 metres (ch 1) canvases whose true
    extents lie in [lo_share * size, size) and are zero beyond."""
    h, w = hw
    ext = torch.stack([
        torch.randint(int(h * lo_share), h, (b,), generator=gen,
                      device=device),
        torch.randint(int(w * lo_share), w, (b,), generator=gen,
                      device=device)], -1).to(torch.int32)
    if ch == 3:
        img = torch.randint(0, 256, (b, h, w, ch), generator=gen,
                            device=device, dtype=torch.uint8)
    else:
        img = 0.5 + 4.0 * torch.rand((b, h, w, ch), generator=gen,
                                     device=device)
    rows = torch.arange(h, device=device)[None, :, None, None]
    cols = torch.arange(w, device=device)[None, None, :, None]
    inside = (rows < ext[:, 0, None, None, None]) & (
        cols < ext[:, 1, None, None, None])
    return img * inside.to(img.dtype), ext


def train_batches(traffic, cfg, seed, device, n=None):
    """The mix's `pool` distinct training batches (or the first n), each
    a dict of device tensors plus the host homographies the gate reads."""
    b, side = traffic['batch_size'], cfg['models']['train']['side']
    canvas = tuple(traffic['canvas'])
    joints, key = cfg['models']['train']['num_joints'], cfg['key_index']
    rng, tseed = rngs(seed, 'train')
    gen = torch.Generator(device=device).manual_seed(tseed)
    out = []
    for _ in range(n or traffic['pool']):
        it = {}
        it['canvases'], it['extents'] = _canvases(gen, b, canvas, 3, 0.75,
                                                  device)
        homs = crop_homographies(rng, b, canvas, side)
        gt = ground_truth(rng, b, joints, side, key)
        it['homs_host'] = homs
        it['homs'] = torch.as_tensor(homs, device=device)
        for k in ('true_cam', 'true_mat', 'true_val', 'intrinsics', 'quads'):
            it[k] = torch.as_tensor(gt[k], device=device)
        lo = torch.tensor([-0.125, 0.8, -18.0, 0.8], device=device)
        hi = torch.tensor([0.125, 1.25, 18.0, 1.25], device=device)
        it['colour'] = lo + (hi - lo) * torch.rand((b, 4), generator=gen,
                                                   device=device)
        if 'depth_canvas' in traffic:
            dhw = tuple(traffic['depth_canvas'])
            it['depth_canvases'], it['depth_extents'] = _canvases(
                gen, b, dhw, 1, 0.9, device)
            dhoms = crop_homographies(rng, b, dhw, side)
            it['depth_homs_host'] = dhoms
            it['depth_homs'] = torch.as_tensor(dhoms, device=device)
            it['atten_map'] = torch.as_tensor(attention_maps(
                side, cfg['models']['train']['stride'], gt['true_mat']),
                device=device)
            f = gt['focal'].mean()
            k_inv = np.linalg.inv(np.array([[f, 0, side / 2],
                                            [0, f, side / 2], [0, 0, 1]]))
            it['k_invs'] = torch.as_tensor(
                np.tile(k_inv, (b, 1, 1)).astype(np.float32), device=device)
        out.append(it)
    return out


def serve_crops(traffic, cfg, seed, device):
    """(pool, S, S, 3) normalised f32 colour crops, NHWC, on the device."""
    side = cfg['models']['serve']['side']
    _, tseed = rngs(seed, 'serve')
    gen = torch.Generator(device=device).manual_seed(tseed)
    raw = torch.randint(0, 256, (traffic['pool'], side, side, 3),
                        generator=gen, device=device, dtype=torch.uint8)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    dev = torch.tensor(IMAGENET_DEV, device=device)
    return (raw.float() / 255.0 - mean) / dev


def arrivals(traffic, seconds, seed):
    """Due times (s from the window's start) of an open-loop Poisson
    stream at traffic['rate'] a second: one fixed set of gaps (seed 0)
    summing to `seconds`, in the seed's order; and the crop each request
    carries (an index into the pool, in the seed's order)."""
    n = int(round(traffic['rate'] * seconds))
    gaps = np.random.default_rng(0).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    rng, _ = rngs(seed, 'arrivals')
    order = rng.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(order)[:-1]])
    crops = rng.permutation(n) % traffic['pool']
    return due, crops
