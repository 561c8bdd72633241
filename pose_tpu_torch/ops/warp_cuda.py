"""The split warp as a hand-written CUDA kernel (port of
pose_tpu/ops/warp_pallas.py::_split_kernel via `warp_batch_split_pallas`).

- `split_warp` — the wrapper: CUDA tensors launch `csrc/split_warp.cu`
  (built with nvcc for sm_90a at first use by `cuda_build`, bound with
  ctypes); CPU tensors
  run `split_warp_plain`. There is no fallback from one to the other: a
  CUDA tensor launches the kernel or raises. `split_warp.launches` counts
  its kernel launches, `split_warp.launches_by_channels` those of each
  instantiation (3: RGB, 1: depth); `launch` is the bare, uncounted launch
  it makes.
- `split_warp_plain` — the plain PyTorch version of the same function: the
  dense stage-A dots and the two-pass matmul stage B in f32 (JAX
  `warp_batch_split(..., stage_b='mxu')`). The CPU and the tests use it;
  nothing on the CUDA path calls it.
- `launch_direct` — the same launch with a budget of 0: every tile from
  the canvas directly, the same bits; the checks hold the staged tiles
  against it.
- `over_budget_tiles` — the kernel's device counter of tiles over
  `SMEM_BUDGET` (computed from the canvas directly); a read syncs, so
  only checks read it.
- `tile_footprints`, `staged_bytes`, `over_budget_count` — the kernel's
  tiling mirrored on the host for the tests and the kernel checks: each
  output tile's footprint in the intermediate, the shared memory its
  staged path needs (the kernel's `staged_bytes` is the definition), and
  how many tiles of a batch exceed a budget.
- `band_ok_v2` — the host gate of the banded TPU kernel (warp_pallas.py:288,
  numpy). The CUDA kernel computes the unbanded warp, which equals the TPU
  kernel's result exactly where this gate admits the batch.

Importing this module compiles nothing and needs no GPU.
"""

import ctypes

import numpy as np
import torch

from .. import cuda_build
from ..cuda_build import check_launch, cuda_stream
from . import warp

_lib = None
# an output tile of the kernel (rows, columns) and the shared memory a tile
# may stage (bytes), allocated to every block: the loader's crops need up
# to 26 KB from uint8 RGB canvases and 15 KB from f32 depth ones, 42 KB from
# f32 RGB ones (tile_footprints); 40 KB keeps 4 blocks on an H100 SM and
# stays under the 48 KB a launch may take without a function attribute
TILE = (16, 32)
SMEM_BUDGET = 40 * 1024
_over = {}                  # device -> the kernel's over-budget counter


def band_ok_v2(homographies, src_hw, out_hw, band=32):
    """Host-side gate of the banded TPU kernel (warp_pallas.py:288): every
    output 8-tile's true source taps (bilinear pair + in-tile spread +
    cross-width deviation from the tile-centre estimate) fit within band/2
    of the estimate. numpy, O(B) scalars."""
    h = np.asarray(homographies, np.float64)
    src_h, src_w = src_hw
    out_h, out_w = out_hw
    if src_h < band + 8 or src_w < band + 8:
        return False

    def y_at(hh, vf, xf):
        denom_u = hh[0, 0] - hh[2, 0] * xf
        if abs(denom_u) < 1e-9:
            return np.nan
        u_of = (xf * (hh[2, 1] * vf + hh[2, 2]) - hh[0, 1] * vf
                - hh[0, 2]) / denom_u
        w_h = hh[2, 0] * u_of + hh[2, 1] * vf + hh[2, 2]
        return (hh[1, 0] * u_of + hh[1, 1] * vf + hh[1, 2]) / w_h

    def x_at(hh, uf, vf):
        d = hh[2, 0] * uf + hh[2, 1] * vf + hh[2, 2]
        if abs(d) < 1e-9:
            return np.nan
        return (hh[0, 0] * uf + hh[0, 1] * vf + hh[0, 2]) / d

    half = band // 2 - 2            # bilinear tap pair
    for hh in h:
        xm = src_w // 2
        vm = out_h // 2
        # in-tile slope at both ends of the sweep (perspective grows the
        # derivative toward one edge); np.maximum propagates NaN
        slope = np.maximum(
            abs(y_at(hh, 8.0, xm) - y_at(hh, 0.0, xm)),
            abs(y_at(hh, out_h - 1.0, xm)
                - y_at(hh, out_h - 9.0, xm))) / 8.0
        slope2 = np.maximum(
            abs(x_at(hh, 8.0, vm) - x_at(hh, 0.0, vm)),
            abs(x_at(hh, out_w - 1.0, vm)
                - x_at(hh, out_w - 9.0, vm))) / 8.0
        if not (np.isfinite(slope) and np.isfinite(slope2)):
            return False
        for vf in (0.0, out_h / 2, out_h - 1.0):
            y_c = y_at(hh, vf, xm)
            if not np.isfinite(y_c):
                return False
            for xf in (0.0, src_w - 1.0):
                yv = y_at(hh, vf, xf)
                if not np.isfinite(yv):
                    return False
                if abs(yv - y_c) + 4.0 * abs(slope) > half:
                    return False
        for uf in (0.0, out_w / 2, out_w - 1.0):
            x_c = x_at(hh, uf, vm)
            if not np.isfinite(x_c):
                return False
            for vf in (0.0, out_h - 1.0):
                xv = x_at(hh, uf, vf)
                if not np.isfinite(xv):
                    return False
                if abs(xv - x_c) + 4.0 * abs(slope2) > half:
                    return False
    return True


def build():
    """Compile csrc/split_warp.cu for sm_90a (once per source content, see
    cuda_build) and load it. Raises if nvcc is missing or the build
    fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load('split_warp')
    lib.split_warp_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.split_warp_launch.restype = ctypes.c_int
    _lib = lib
    return lib


def pack_scalars(residual, scale, extents):
    """(B, 15) f32 rows [R (9) | ystep ystart xstep xstart | eh ew], the
    TPU kernel's scalar layout (warp_pallas.py:437-440)."""
    b = residual.shape[0]
    return torch.cat([residual.reshape(b, 9).to(torch.float32),
                      scale.reshape(b, 4).to(torch.float32),
                      extents.reshape(b, 2).to(torch.float32)],
                     dim=1).contiguous()


def split_warp_plain(canvases, residual, scale, extents, out_shape, m,
                     post_scale, wdtype):
    """Plain PyTorch split warp, the function `split_warp` computes: stage A
    as dense dots (warp.scale_resample_planar), stage B as the two-pass
    matmul warp over the full (m, m) intermediate in f32. Returns
    (B, C, out_h, out_w) f32."""
    inter = warp.scale_resample_planar(canvases, scale, extents, m, wdtype,
                                       post_scale)
    return warp.warp_batch_mxu(inter.permute(0, 2, 3, 1), residual,
                               out_shape,
                               wdtype=torch.float32).permute(0, 3, 1, 2)


def split_warp(canvases, residual, scale, extents, out_shape, m, post_scale,
               wdtype):
    """The split warp: (B, H, W, C) uint8/f32 canvases, (B, 3, 3) residual
    homographies and (B, 2, 2) axis-aligned scale rows from
    `warp.decompose_homography`, (B, 2) source extents -> (B, C, out_h,
    out_w) f32 crops.

    CUDA tensors launch the kernel on the current stream (and count it in
    `split_warp.launches`); it takes RGB canvases (C = 3, uint8 or f32,
    bf16 or f32 weights) and raw-depth canvases (C = 1, f32 with f32
    weights). CPU tensors run `split_warp_plain`."""
    if canvases.device.type == 'cpu':
        return split_warp_plain(canvases, residual, scale, extents,
                                out_shape, m, post_scale, wdtype)
    if canvases.device.type != 'cuda':
        raise ValueError(f'split_warp: unsupported device {canvases.device}')
    if canvases.dim() != 4 or canvases.dtype not in (torch.uint8,
                                                     torch.float32):
        raise ValueError('split_warp: canvases must be (B, H, W, C) uint8 or '
                         f'float32, got {tuple(canvases.shape)} '
                         f'{canvases.dtype}')
    if not canvases.is_contiguous():
        raise ValueError('split_warp: canvases must be contiguous')
    b, src_h, src_w, n_ch = canvases.shape
    if n_ch not in (1, 3):
        raise ValueError(f'split_warp: 3 (RGB) or 1 (depth) channels, got '
                         f'{n_ch}')
    if tuple(residual.shape) != (b, 3, 3) or tuple(scale.shape) != (b, 2, 2):
        raise ValueError('split_warp: residual must be (B, 3, 3) and scale '
                         f'(B, 2, 2), got {tuple(residual.shape)} and '
                         f'{tuple(scale.shape)}')
    if extents.numel() != 2 * b:
        raise ValueError(f'split_warp: extents must be (B, 2), got '
                         f'{tuple(extents.shape)}')
    if wdtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f'split_warp: wdtype bf16 or f32, got {wdtype}')
    if n_ch == 1 and (canvases.dtype != torch.float32
                      or wdtype != torch.float32):
        raise ValueError('split_warp: one-channel (depth) canvases must be '
                         f'float32 with float32 weights, got {canvases.dtype}'
                         f' with {wdtype}')
    for name, t in (('residual', residual), ('scale', scale),
                    ('extents', extents)):
        if t.device != canvases.device:
            raise ValueError(f'split_warp: {name} on {t.device}, canvases '
                             f'on {canvases.device}')
    out_h, out_w = out_shape
    scal = pack_scalars(residual, scale, extents)
    out = torch.empty((b, n_ch, out_h, out_w), dtype=torch.float32,
                      device=canvases.device)
    launch(canvases, scal, out, m, post_scale, wdtype)
    split_warp.launches += 1
    split_warp.launches_by_channels[n_ch] += 1
    return out


# launches in all, and by instantiation: 3 (RGB) and 1 (depth) channels
split_warp.launches = 0
split_warp.launches_by_channels = {3: 0, 1: 0}


def over_counter(device):
    """The kernel's device counter of over-budget tiles on `device` (int32,
    made at first use)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _over:
        _over[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _over[device]


def over_budget_tiles(device, reset=False):
    """The tiles the kernel has computed from the canvas directly (over its
    budget) on `device` since the last reset; reads the device, so only
    checks call it."""
    counter = over_counter(device)
    n = int(counter.item())
    if reset:
        counter.zero_()
    return n


def _launch(canvases, scal, out, m, post_scale, wdtype, budget):
    lib = build()
    b, src_h, src_w, n_ch = canvases.shape
    with torch.cuda.device(canvases.device):
        err = lib.split_warp_launch(
            canvases.data_ptr(), int(canvases.dtype == torch.uint8),
            scal.data_ptr(), out.data_ptr(), b, src_h, src_w, n_ch, m,
            out.shape[2], out.shape[3], float(post_scale),
            int(wdtype == torch.bfloat16), budget,
            over_counter(canvases.device).data_ptr(), cuda_stream(canvases))
    check_launch(lib, err, 'split_warp')


def launch(canvases, scal, out, m, post_scale, wdtype):
    """One launch of the kernel on the current stream, with no checks and
    no count: checked (B, H, W, C) canvases, (B, 15) scalars from
    `pack_scalars`, and an allocated (B, C, out_h, out_w) f32 `out`.
    `split_warp` calls it; a benchmark can time the kernel alone with it."""
    _launch(canvases, scal, out, m, post_scale, wdtype, SMEM_BUDGET)


def launch_direct(canvases, scal, out, m, post_scale, wdtype):
    """`launch` with a budget of 0: every tile computed from the canvas
    directly, as an over-budget tile is. The same bits as `launch`; the
    checks compare the two."""
    _launch(canvases, scal, out, m, post_scale, wdtype, 0)


# ------------------------------------------------------- tiles on the host


def _hat_taps(t, n, lim):
    """The kernel's hat_taps on f32 tensors: (first index, weights (..., 2)),
    weights zero for taps out of [0, n) or beyond lim, or t non-finite."""
    ok = (t > -1.0) & (t < n)
    f0 = torch.floor(torch.where(ok, t, torch.zeros_like(t)))
    f1 = f0 + 1.0
    tri = lambda d: torch.clamp(1.0 - torch.abs(d), min=0.0)  # noqa: E731
    zero = torch.zeros_like(t)
    w0 = torch.where(ok & (f0 >= 0) & (f0 <= lim), tri(t - f0), zero)
    w1 = torch.where(ok & (f1 < n) & (f1 <= lim), tri(t - f1), zero)
    return f0.long(), torch.stack([w0, w1], -1)


def tile_footprints(residual, scale, extents, out_hw, m, tile=TILE):
    """Phase 1 of the kernel on the host: for each (rows x cols) output
    tile, the range of intermediate rows p and columns q that its stage-B
    taps read with nonzero weight, from the kernel's f32 expressions
    (warp.col_map and the row map at each tap column). (B, 3, 3) residual,
    (B, 2, 2) scale, (B, 2) extents -> (B, tiles_y, tiles_x, 4) int64
    [pmin, pmax, qmin, qmax]; an empty footprint has pmin > pmax."""
    h = residual.detach().to('cpu', torch.float32).reshape(-1, 9)
    b = h.shape[0]
    out_h, out_w = out_hw
    lim = float(m - 1)
    x_map = warp.col_map(h.reshape(b, 3, 3), out_hw)
    x_map = torch.where(x_map == -1e9, torch.full_like(x_map, float('nan')),
                        x_map)
    sx0, wx = _hat_taps(x_map, m, lim)                    # (b, oh, ow)
    hk = [h[:, k, None, None] for k in range(9)]
    vf = torch.arange(out_h, dtype=torch.float32)[None, :, None]
    big = 1 << 40           # above any index; exact through F.pad's float
    p_lo = torch.full((b, out_h, out_w), big, dtype=torch.int64)
    p_hi = torch.full((b, out_h, out_w), -1, dtype=torch.int64)
    q_lo, q_hi = p_lo.clone(), p_hi.clone()
    for kx in range(2):
        on = wx[..., kx] > 0
        xs = sx0 + kx
        xf = xs.to(torch.float32)
        # the kernel's row_map at (v, xs), in its operation order
        denom_u = hk[0] - hk[6] * xf
        u_of = (xf * (hk[7] * vf + hk[8]) - hk[1] * vf - hk[2]) / denom_u
        w_h = hk[6] * u_of + hk[7] * vf + hk[8]
        y = (hk[3] * u_of + hk[4] * vf + hk[5]) / w_h
        sy0, wy = _hat_taps(y, m, lim)
        q_lo = torch.where(on, torch.minimum(q_lo, xs), q_lo)
        q_hi = torch.where(on, torch.maximum(q_hi, xs), q_hi)
        for ky in range(2):
            hit = on & (wy[..., ky] > 0)
            p_lo = torch.where(hit, torch.minimum(p_lo, sy0 + ky), p_lo)
            p_hi = torch.where(hit, torch.maximum(p_hi, sy0 + ky), p_hi)
    th, tw = tile
    ty, tx = -(-out_h // th), -(-out_w // tw)
    pad = (0, tx * tw - out_w, 0, ty * th - out_h)
    out = []
    for t, fill, red in ((p_lo, big, torch.amin), (p_hi, -1, torch.amax),
                         (q_lo, big, torch.amin), (q_hi, -1, torch.amax)):
        t = torch.nn.functional.pad(t, pad, value=fill)
        out.append(red(t.reshape(b, ty, th, tx, tw), dim=(2, 4)))
    return torch.stack(out, -1)


def staged_bytes(footprints, scale, extents, n_ch, elem):
    """The shared memory (bytes) each tile's staged path needs, as the
    kernel computes it (split_warp.cu: staged_bytes): the canvas rectangle
    under the footprint's stage-A taps, clipped to the extent, in rows of
    (nx * C * elem + 6) // 4 words and a byte shift each; the row and
    column tap tables; the (C, np, nq) f32 stage-A values. (B, ty, tx)
    int64; 0 for an empty footprint, 2^62 where the scalars are not
    finite."""
    def al16(n):
        return (n + 15) // 16 * 16

    fp = footprints
    b = fp.shape[0]
    sc = scale.detach().to('cpu', torch.float32).reshape(b, 1, 1, 2, 2)
    ext = extents.detach().to('cpu', torch.float32).reshape(b, 1, 1, 2)
    n_p = (fp[..., 1] - fp[..., 0] + 1).clamp(min=0)
    n_q = (fp[..., 3] - fp[..., 2] + 1).clamp(min=0)
    empty = n_p == 0
    pq = torch.where(empty[..., None], torch.zeros_like(fp), fp).float()
    # ya and xa at the footprint's ends (start + p * step, in f32)
    ya = sc[..., 0, 1, None] + pq[..., 0:2] * sc[..., 0, 0, None]
    xa = sc[..., 1, 1, None] + pq[..., 2:4] * sc[..., 1, 0, None]
    finite = torch.isfinite(ya).all(-1) & torch.isfinite(xa).all(-1)

    def span(a, lim):
        lo = torch.clamp(torch.floor(a.amin(-1)), min=0.0)
        hi = torch.minimum(torch.floor(a.amax(-1)) + 1.0, lim)
        n = torch.where(hi >= lo, hi - lo + 1.0, torch.zeros_like(hi))
        return torch.nan_to_num(n).long()

    ny = span(ya, torch.floor(ext[..., 0] - 1.0))
    nx = span(xa, torch.floor(ext[..., 1] - 1.0))
    none = (ny == 0) | (nx == 0)
    ny, nx = ny.masked_fill(none, 0), nx.masked_fill(none, 0)
    need = (al16(ny * ((nx * n_ch * elem + 6) // 4) * 4) + al16(4 * ny)
            + al16(12 * (n_p + n_q)) + al16(4 * n_ch * n_p * n_q))
    need = torch.where(empty, torch.zeros_like(need), need)
    return torch.where(empty | finite, need, torch.full_like(need, 1 << 62))


def over_budget_count(residual, scale, extents, out_hw, m, n_ch, elem,
                      budget=SMEM_BUDGET):
    """How many output tiles of this batch the kernel computes from the
    canvas directly, its staged path needing more than `budget` bytes."""
    fp = tile_footprints(residual, scale, extents, out_hw, m)
    return int((staged_bytes(fp, scale, extents, n_ch, elem) > budget).sum())
