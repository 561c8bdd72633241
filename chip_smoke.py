"""Chip smoke test of the PyTorch/CUDA port (pose_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only split,split_depth,stem   # kernel phases

`--only` also runs from the root of an earlier checkout whose wrappers
predate staged split tiles and the packed stem weight (no
warp_cuda.launch_direct, no stem.pack_weight): it then times that
checkout's kernels at the same shapes and leaves out the staged-vs-direct
check, which is how the earlier kernels' times beside the new ones are
taken.

Phases (any failure exits non-zero; no exception is swallowed):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every kernel from the sources in the checkout (nvcc, sm_90a),
     one nvcc per source, all started together;
  3. kernel phases: each kernel against its plain PyTorch version on the
     card at the main paths' shapes, with its error, its time, its plain
     version's time, its bound and, where one PyTorch call computes the
     same function, that call's time:
     - split warp: B=8, 512x512 uint8 canvases -> 257x257, m 256, bf16 and
       f32 weights, full and smaller extents, and B=64 (the training
       batches); and its depth instantiation: (64, 424, 512, 1) f32
       raw-depth canvases, f32 weights; each also through launch_direct
       (every tile from the canvas directly), which must give the same
       bits, and its over-budget tile counter against tile_footprints'
       prediction;
     - the four fused-BN kernels: the stem's (1,065,024 x 64, relu) and a
       layer4 tail's (18,496 x 2048, residual + relu) (M, C), bf16 and f32;
     - the banded warp at stage B of the split warp, (64, C, 256, 256) f32
       for C = 1 and 3, and on whole 512^2 canvases with crops its gate
       admits, where it is also held against the full-scanline oracle,
       whose own phase this is;
     - the partial-conv renorm pair at the 22 partial-conv shapes of the
       partial_depth ResNet-50 at batch 64, bf16 and f32, through
       partial_conv(use_pallas=True), forward and backward by autograd;
  4. reference phases: the serving slice at a small size on the card
     (kernel, cuDNN) against the same slice on the CPU (plain versions),
     two joint+track train steps of a small bn_impl='pallas' model, and
     two distillation steps and two partial_depth steps of small models,
     on the card against the CPU;
  5. serve phase, a main path: 64 full frames -> gated split warp ->
     BatchingServer on the full-width ResNet-50 half_acc Predictor (random
     weights from a seed), 64 single-crop requests in 8 batches, each
     answer checked against predict_crops on the same crops,
     predict_absolute on one batch; the first batch's time is reported
     apart from the median of the others;
  6. train phase, the training main path: RgbTrainer.train on the
     flagship cmu_train.sh configuration (ResNet-50, 257^2, stride 16,
     joint_space, do_track, extra_channel, half_acc, batch 64) with
     bn_impl='pallas' and seeded weights, over batches of seeded 512^2
     uint8 frames through the gated split warp plus the bbox-mask channel:
     epoch 1 (4 steps, no track) and epoch 2 (4 steps, track). Then one
     profiled step and, as a breakdown, the same step with bn_impl='xla';
  7. distill phase, the depth stack's main path: DepthTrainer.train with
     -do_teach -do_fusion -attention on the ntu_train.sh flags, a fusion
     ResNet-50 teacher and a depth ResNet-50 student on colour, both with
     bn_impl='pallas', batch 64, two epochs of 4 steps: colour through the
     gated split warp, seeded 424x512 raw-depth canvases through
     process_depth_batch, epoch 1 by the split kernel at one channel,
     epoch 2 by the two-kernel split warp (the banded kernel);
  8. partial_depth phase: -partial_conv -depth_only, vanilla_train of a
     partial_depth ResNet-50, 4 steps at batch 64;
  9. entry phase, the RGB entry point's main path: pose_tpu_torch.main with
     cmu_train.sh's flags (-pretrain from a seeded torchvision-key
     ResNet-50) and POSE_TPU_BN=pallas on a seeded CMU-style store of
     1080x1920 JPEG frames: two epochs of 4 train steps (split warp,
     fused BN) and a test epoch of 2 batches (the stem kernel in the eval
     forward), checkpoints, then -val_only, whose SPEC line must equal the
     trained run's; a profiled test batch and a profiled train step (no
     stem kernel in it).
The stem kernel's own phase (after the renorm pair's) holds it against its
plain version at (64, Cin, 257, 257) for Cin 4, 3 and 1 and at the serving
shape (8, 4, 257, 257).
Kernel launch counts are set to 0 just before each main path and read just
after it; so is the split kernel's over-budget tile counter, which must
read 0 (tile_footprints predicts 0 for crops drawn as the paths draw
them: the kernel phases above and tests/test_torch_warp.py).
Then one JSON line {"kernels": [...]} and, last, the JSON line
{"ok": true, "device": {...}}.

All data and weights are generated from fixed seeds; nothing is fetched.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
B, CANVAS, SIDE = 8, 512, 257
N_FRAMES = 64
# H100 SXM peaks (NVIDIA data sheet, dense): device memory and float32
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# dense bf16 on the tensor cores (the stem's bf16 x bf16 products)
BF16_FLOP_PER_S = 989e12
# kernel vs its plain version on the same card tensors: the same f32
# operations in the same order, the 2-term sums in another order than
# cuBLAS's; values in [0, 1]
KERNEL_TOL = 1e-5
# fused-BN kernels vs their plain versions: channel sums in another order
# within SUM_TOL of the sum of the terms' magnitudes; the (C,) coefficients
# from the same sums by the same f32 formulas within COEF_TOL of each row's
# largest value (rsqrtf and torch.rsqrt may differ by an ulp); y, dx within
# one ulp of their dtype (the same f32 operations; a cast may flip), dres
# exact
SUM_TOL = 1e-5
COEF_TOL = 1e-6
# the BN shapes of the flagship step at batch 64: the stem (129^2 x 64,
# relu) and a layer4 block tail (17^2 x 2048, residual + relu)
BN_SHAPES = (('stem', 64, 129, 64, True, False),
             ('layer4 tail', 64, 17, 2048, True, True))
TRAIN_B, TRAIN_STEPS = 64, 4      # per epoch; two epochs
N_BN = 53                          # BN layers of ResNet-50
H36M_KEY = 16                      # the NTU/PKU 17-joint root (pelvis)
DEPTH_STEPS = 4                    # depth-engine steps per epoch
# the depth stream: Kinect v2 depth frames (NTU RGB+D), batch 64
DEPTH_B, DEPTH_H, DEPTH_W = 64, 424, 512
# the stem kernel against its plain version: the same exact bf16 x bf16
# products summed in f32 on the tensor cores in another order than cuDNN's
# (and, within a k-group, aligned to the largest exponent before the adds):
# a sum of K f32 terms is within K * 2^-23 of its sum of |terms|
def stem_tol(cin):
    return 49 * cin * 2.0 ** -23


# the entry point's store: Panoptic HD frames, 4 train steps and 2 test
# batches of 64 per epoch
ENTRY_HD = (1080, 1920)
ENTRY_TRAIN, ENTRY_VALID = 256, 128


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def realistic_homs(rng, b, canvas, side_in):
    """Crop homographies as the runtime loader produces them (copied from
    bench.py): the side_in^2 output maps to a ~1.5*side_in region of the
    canvas with random placement, zoom in [0.9, 1/0.9], small rotation and
    perspective."""
    homs = np.zeros((b, 3, 3), np.float32)
    for i in range(b):
        zoom = rng.uniform(0.9, 1.0 / 0.9)
        s = 384.0 / side_in / zoom
        th = rng.uniform(-0.05, 0.05)
        c, sn = np.cos(th), np.sin(th)
        span = s * side_in
        tx = rng.uniform(0, max(canvas - span, 1))
        ty = rng.uniform(0, max(canvas - span, 1))
        homs[i] = [[s * c, -s * sn, tx],
                   [s * sn, s * c, ty],
                   [rng.uniform(-1, 1) * 2e-5, rng.uniform(-1, 1) * 2e-5,
                    1.0]]
    return homs


def make_frames(rng, n, canvas, side_in, small_extents):
    """n uint8 canvases (numpy), crop homographies and extents; with
    small_extents each frame's true extent is smaller than the canvas and
    the rest is zero padding, as the loader packs variable-size frames."""
    frames = rng.randint(0, 256, (n, canvas, canvas, 3), dtype=np.uint8)
    ext = np.full((n, 2), canvas, np.int32)
    if small_extents:
        ext = rng.randint(canvas * 3 // 4, canvas, (n, 2)).astype(np.int32)
        for i, (h, w) in enumerate(ext):
            frames[i, h:] = 0
            frames[i, :, w:] = 0
    return frames, realistic_homs(rng, n, canvas, side_in), ext


def time_ms(fn, iters, flush=None):
    """Median time of fn() in ms over `iters` calls, each between two CUDA
    events, after 3 warm-up calls: device time plus whatever host time fn
    spends between its launches. With `flush` (a buffer larger than the
    50 MB L2), the L2 is overwritten before every call, so the inputs come
    from device memory as they do for a fresh batch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_ms(launch, name, iters, flush=None):
    """Median duration in ms of the device kernel whose name contains
    `name`, over `iters` calls of launch() (one launch each); see
    device_ms."""
    return device_ms({name: (launch, name, 1)}, iters, flush)[name]


def _taps(t, n, lim):
    """Tap indices (..., 2) of hat positions t over [0, n) with i <= lim
    (lim broadcast against t), n where a tap has no weight; the kernels'
    taps: floor(t) and floor(t) + 1, each kept where it lies in range and
    its weight is nonzero."""
    f0 = torch.floor(t)
    idx = torch.stack([f0, f0 + 1.0], -1)
    w = torch.stack([1.0 - (t - f0), t - f0], -1)
    ok = ((t > -1.0) & (t < n))[..., None] & (idx >= 0) & (idx < n) \
        & (idx <= lim[..., None]) & (w > 0)
    return torch.where(ok, idx, torch.full_like(idx, n)).long()


def _mark(shape, n, idx):
    """Boolean (b, n, *shape) marks of the indices idx (b, k, *shape) along
    dim 1; index n (no weight) lands in a row that is dropped."""
    hit = torch.zeros((idx.shape[0], n + 1) + shape, dtype=torch.float32,
                      device=idx.device)
    return hit.scatter_(1, idx, 1.0)[:, :n] > 0


def two_pass_reads(homs, src_hw, out_hw, extents):
    """The source pixels a two-pass warp reads with nonzero weight: those
    under the pass-1 taps of the pass-1 values (v, xs) that pass 2 samples,
    within each extent. Returns ((B, H, W) bool, (B, out_h, W) bool of
    the pass-1 values used)."""
    from pose_tpu_torch.ops import warp

    b = homs.shape[0]
    src_h, src_w = src_hw
    out_h = out_hw[0]
    ext = extents.reshape(b, 2).to(torch.float32)
    lim_y = (ext[:, 0] - 1.0)[:, None, None]
    lim_x = (ext[:, 1] - 1.0)[:, None, None]
    xi = _taps(warp.col_map(homs, out_hw), src_w, lim_x)     # (b, oh, ow, 2)
    used_vx = _mark((out_h,), src_w,
                    xi.reshape(b, out_h, -1).transpose(1, 2)).transpose(1, 2)
    yi = _taps(warp.row_map(homs, out_h, src_w), src_h, lim_y)
    yi = torch.where(used_vx[..., None], yi, torch.full_like(yi, src_h))
    read = _mark((src_w,), src_h, yi.permute(0, 1, 3, 2).reshape(b, -1,
                                                                 src_w))
    return read, used_vx


def two_pass_work(homs, src_hw, out_hw, extents, n_ch, elem, n_scal):
    """Bytes and f32 operations of a two-pass warp on this run's data: the
    source pixels read (each once), the (B, n_scal) scalars and the f32
    crops (each written once); 2 operations per tap and channel of pass 1
    on each used pass-1 value and of pass 2 on each output pixel. Returns
    (bytes, flops, read mask)."""
    b = homs.shape[0]
    out_h, out_w = out_hw
    read, used_vx = two_pass_reads(homs, src_hw, out_hw, extents)
    n_bytes = (int(read.sum()) * n_ch * elem + b * n_scal * 4
               + b * n_ch * out_h * out_w * 4)
    n_flops = 4 * n_ch * (int(used_vx.sum()) + b * out_h * out_w)
    return n_bytes, n_flops, read


def split_warp_work(canvases, residual, scale, extents, out_hw, m):
    """What the split warp must do for this run's data, for its bound:
    the canvas pixels under the stage-A taps of the intermediate pixels
    that stage B samples with nonzero weight, within each extent (each read
    once), the (B, 15) scalars and the f32 crops (each written once); and
    the f32 multiply-adds of its separable 2-tap form on those pixels (2 per
    tap and channel; the maps and weights are not counted). Returns
    (bytes, flops, the (B, H, W) boolean mask of the canvas pixels read)."""
    b, src_h, src_w, n_ch = canvases.shape
    out_h, out_w = out_hw
    dev = canvases.device
    full = torch.full((b, 2), float(m), device=dev)
    inter, used_vx = two_pass_reads(residual, (m, m), out_hw, full)
    # stage A: canvas rows and columns under those pixels' taps
    p = torch.arange(m, dtype=torch.float32, device=dev)[None]
    scale = scale.to(torch.float32)
    ext = extents.reshape(b, 2).to(torch.float32)
    rows = _taps(scale[:, 0, 1, None] + p * scale[:, 0, 0, None], src_h,
                 ext[:, :1] - 1.0)                            # (b, m, 2)
    cols = _taps(scale[:, 1, 1, None] + p * scale[:, 1, 0, None], src_w,
                 ext[:, 1:] - 1.0)
    row_of = _mark((m,), src_h, rows.transpose(1, 2)).float()  # (b, H, m)
    col_of = _mark((m,), src_w, cols.transpose(1, 2)).float()  # (b, W, m)
    t1 = (inter.float() @ col_of.transpose(1, 2)) > 0         # (b, m, W)
    read = (row_of @ t1.float()) > 0                          # (b, H, W)
    n_bytes = (int(read.sum()) * n_ch * canvases.element_size() + b * 15 * 4
               + b * n_ch * out_h * out_w * 4)
    n_flops = 4 * n_ch * (int(t1.sum()) + int(inter.sum())
                          + int(used_vx.sum()) + b * out_h * out_w)
    return n_bytes, n_flops, read


def card_line():
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def split_timing(canvases, residual, scale, extents, m, post, wdtype,
                 flush):
    """The split kernel alone at one shape (scalars packed once, bare
    uncounted launches, L2 flushed before each, profiler records), its
    plain version between CUDA events and its bound on these inputs.
    Returns a dict of the numbers and the pixels read."""
    from pose_tpu_torch.ops import warp_cuda

    b, _, _, n_ch = canvases.shape
    out = torch.empty((b, n_ch, SIDE, SIDE), dtype=torch.float32,
                      device=canvases.device)
    scal = warp_cuda.pack_scalars(residual, scale, extents)
    args = (canvases, residual, scale, extents, (SIDE, SIDE), m, post, wdtype)

    def bare():
        warp_cuda.launch(canvases, scal, out, m, post, wdtype)

    ms = kernel_ms(bare, 'split_warp_kernel', 50, flush)
    plain_ms = time_ms(lambda: warp_cuda.split_warp_plain(*args), 5, flush)
    n_bytes, n_flops, read = split_warp_work(canvases, residual, scale,
                                             extents, (SIDE, SIDE), m)
    bound, by = bound_of(n_bytes, n_flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                n_bytes=n_bytes, n_flops=n_flops, read=int(read.sum()))


def staged_vs_direct(args, label):
    """The split kernel through its wrapper (tiles staged in shared memory
    within warp_cuda.SMEM_BUDGET) and through launch_direct (every tile
    from the canvas directly): the outputs must be equal bit for bit, and
    the kernel's over-budget counter must equal tile_footprints' prediction
    for each budget. Returns the wrapper's output (alone, in a checkout
    whose kernel stages no tiles)."""
    from pose_tpu_torch.ops import warp_cuda

    if not hasattr(warp_cuda, 'launch_direct'):
        print(f'split_warp {label}: a kernel without staged tiles', flush=True)
        return warp_cuda.split_warp(*args)
    canvases, residual, scale, extents, out_hw, m, post, wdtype = args
    dev = canvases.device
    n_ch, elem = canvases.shape[3], canvases.element_size()
    warp_cuda.over_budget_tiles(dev, reset=True)
    out = warp_cuda.split_warp(*args)
    over = warp_cuda.over_budget_tiles(dev, reset=True)
    direct = torch.empty_like(out)
    warp_cuda.launch_direct(canvases, warp_cuda.pack_scalars(residual, scale,
                                                             extents),
                            direct, m, post, wdtype)
    over0 = warp_cuda.over_budget_tiles(dev, reset=True)
    want = [warp_cuda.over_budget_count(residual, scale, extents, out_hw, m,
                                        n_ch, elem, budget)
            for budget in (warp_cuda.SMEM_BUDGET, 0)]
    same = torch.equal(out, direct)
    print(f'split_warp {label}: staged == direct bit for bit: '
          f'{same}; over-budget tiles {over} (predicted {want[0]}), with '
          f'budget 0 {over0} (predicted {want[1]})', flush=True)
    check(same, f'split_warp {label}: staged and direct tiles differ')
    check([over, over0] == want, f'split_warp {label}: over-budget tiles '
          f'{[over, over0]}, predicted {want}')
    return out


def split_warp_phase(dev):
    """Kernel phase of the split warp at the serving shape (B=8: bf16 and
    f32 weights, full and smaller extents, against the plain version) and
    at the training shape (B=64, the train, distill and entry batches)."""
    from pose_tpu_torch.ops import warp, warp_cuda

    rng = np.random.RandomState(SEED)
    m = warp.split_defaults((SIDE, SIDE))[0]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    errs, shapes = {}, {}
    for small in (False, True):
        frames, homs, ext = make_frames(rng, B, CANVAS, SIDE, small)
        check(warp.split_band_ok(homs, (SIDE, SIDE)),
              'serving homographies must pass the split gate')
        canvases = torch.as_tensor(frames).to(dev)
        extents = torch.as_tensor(ext).to(dev)
        residual, scale = warp.decompose_homography(
            torch.as_tensor(homs).to(dev), (SIDE, SIDE), m)
        for wdtype in (torch.bfloat16, torch.float32):
            args = (canvases, residual, scale, extents, (SIDE, SIDE), m,
                    1.0 / 255.0, wdtype)
            name = f'{"extents" if small else "full"}/{str(wdtype)[6:]}'
            out = staged_vs_direct(args, name)
            ref = warp_cuda.split_warp_plain(*args)
            torch.cuda.synchronize()
            check(out.shape == (B, 3, SIDE, SIDE) and out.dtype ==
                  torch.float32, f'split_warp output {tuple(out.shape)}')
            check(bool(torch.isfinite(out).all()), 'split_warp non-finite')
            err = float((out - ref).abs().max())
            errs[name] = err
            print(f'split_warp {name}: max_abs_err {err:.3g} '
                  f'(tol {KERNEL_TOL:g})', flush=True)
            check(err <= KERNEL_TOL, f'split_warp {name} disagrees with its '
                  f'plain version: {err} > {KERNEL_TOL}')
        # the serving configuration: uint8 canvases, bf16 weights
        if not small:
            shapes[f'serve {B}x{CANVAS}^2x3 u8'] = split_timing(
                canvases, residual, scale, extents, m, 1.0 / 255.0,
                torch.bfloat16, flush)
    # the training shape: the train, distill and entry batches of 64
    frames, homs, ext = make_frames(rng, TRAIN_B, CANVAS, SIDE, True)
    check(warp.split_band_ok(homs, (SIDE, SIDE)),
          'training homographies must pass the split gate')
    canvases = torch.as_tensor(frames).to(dev)
    extents = torch.as_tensor(ext).to(dev)
    residual, scale = warp.decompose_homography(
        torch.as_tensor(homs).to(dev), (SIDE, SIDE), m)
    args = (canvases, residual, scale, extents, (SIDE, SIDE), m, 1.0 / 255.0,
            torch.bfloat16)
    err = float((staged_vs_direct(args, f'train B={TRAIN_B}')
                 - warp_cuda.split_warp_plain(*args)).abs().max())
    errs[f'train B={TRAIN_B}'] = err
    check(err <= KERNEL_TOL, f'split_warp at B={TRAIN_B} disagrees with its '
          f'plain version: {err} > {KERNEL_TOL}')
    shapes[f'train {TRAIN_B}x{CANVAS}^2x3 u8'] = split_timing(
        canvases, residual, scale, extents, m, 1.0 / 255.0, torch.bfloat16,
        flush)
    for name, t in shapes.items():
        print(f'split_warp {name}: kernel {t["ms"]:.5f} ms (L2 flushed); '
              f'plain {t["plain_ms"]:.4f} ms (events); bound '
              f'{t["bound_ms"]:.5f} ms by {t["bound_by"]} ({t["n_bytes"]} B:'
              f' {t["read"]} canvas pixels read; {t["n_flops"]} flop); '
              f'{100 * t["bound_ms"] / t["ms"]:.1f} % of the bound',
              flush=True)
    serve = shapes[f'serve {B}x{CANVAS}^2x3 u8']
    return dict(name='split_warp', route='cuda',
                source='pose_tpu_torch/csrc/split_warp.cu',
                replaces='pose_tpu/ops/warp_pallas.py:231',
                max_abs_err=max(errs.values()), ms=serve['ms'],
                plain_ms=serve['plain_ms'], bound_ms=serve['bound_ms'],
                bound_by=serve['bound_by'], library_ms=None,
                shapes={k: {f: v[f] for f in ('ms', 'plain_ms', 'bound_ms',
                                              'bound_by')}
                        for k, v in shapes.items()})


def reference_phase(dev):
    """The slice at a small size on the card against the CPU. Crops: frames
    -> gated split warp (the kernel, bf16 weights, the card's default) ->
    clip -> normalise, against the plain version on the CPU with the same
    bf16 weights and the same residual and scale rows (computed on the card
    as the slice computes them: bf16 hat weights turn a last-bit
    difference of a sample position into a 2^-8 step); tolerance 1e-5 /
    0.225, the kernel phase's through the normalisation. Predictions: the
    same crops through an f32 Predictor on the card (cuDNN, TF32 off) and
    on the CPU; tolerances 0.05 mm, 0.005 px and 1 mm after the root solve
    (f32 convolutions summed in another order, on ~1000 mm values)."""
    from pose_tpu_torch import serve
    from pose_tpu_torch.ops import colour, warp, warp_cuda

    rng = np.random.RandomState(SEED + 1)
    args = serve.default_args(model='resnet18', side_in=65, stride=32,
                              depth=4, num_joints=5, half_acc=False)
    frames, homs, ext = make_frames(rng, 4, 128, 65, True)
    # the serving crop distribution scaled down: a 65^2 crop of a 128^2
    # canvas covers what a 257^2 crop of a 512^2 canvas does
    homs = (np.diag([0.25, 0.25, 1.0]) @ realistic_homs(rng, 4, 512, 257)
            @ np.diag([257 / 65, 257 / 65, 1.0])).astype(np.float32)
    intr = np.tile(np.array([[100., 0, 32], [0, 100., 32], [0, 0, 1]],
                            np.float32), (4, 1, 1))
    pre = serve.GatedPreprocessor(65, device=dev)
    crops = pre(frames, homs, ext)
    check(pre.split_batches == 1, 'reference frames must pass the gate')
    m = warp.split_defaults((65, 65))[0]
    residual, scale = warp.decompose_homography(
        torch.as_tensor(homs).to(dev), (65, 65), m)
    ref = warp_cuda.split_warp_plain(
        torch.as_tensor(frames), residual.cpu(), scale.cpu(),
        torch.as_tensor(ext), (65, 65), m, 1.0 / 255.0, torch.bfloat16)
    ref = colour.normalize_imagenet_planar(torch.clamp(ref, 0.0, 1.0))
    warp_err = float((crops.cpu() - ref.permute(0, 2, 3, 1)).abs().max())
    outs = {}
    for device in (dev, 'cpu'):
        pred = serve.Predictor(args, batch_size=4, device=device, seed=SEED)
        outs[device] = (pred.predict_crops(crops),
                        pred.predict_absolute(crops, intr))
    (p_gpu, a_gpu), (p_cpu, a_cpu) = outs[dev], outs['cpu']
    relat_err = float(np.abs(p_gpu['relat_cam'] - p_cpu['relat_cam']).max())
    spec_err = float(np.abs(p_gpu['spec_mat'] - p_cpu['spec_mat']).max())
    abs_err = float(np.abs(a_gpu - a_cpu).max())
    print(f'reference (card vs CPU, small slice): crops {warp_err:.3g}, '
          f'relat_cam {relat_err:.3g} mm, spec_mat {spec_err:.3g} px, '
          f'absolute {abs_err:.3g} mm', flush=True)
    check(warp_err <= KERNEL_TOL / 0.225, f'crops differ: {warp_err}')
    check(relat_err <= 0.05, f'relat_cam differs: {relat_err}')
    check(spec_err <= 0.005, f'spec_mat differs: {spec_err}')
    check(abs_err <= 1.0, f'absolute differs: {abs_err}')


class NoTilesOverBudget:
    """Around a main path: zeroes the split kernel's over-budget tile
    counter before the path and checks after it that the counter reads 0,
    as tile_footprints predicts for the crops the paths draw. Nothing runs
    inside the path."""

    def __init__(self, name, dev):
        self.name, self.dev = name, dev

    def __enter__(self):
        from pose_tpu_torch.ops import warp_cuda
        warp_cuda.over_budget_tiles(self.dev, reset=True)
        return self

    def __exit__(self, kind, value, tb):
        from pose_tpu_torch.ops import warp_cuda
        if kind is None:
            over = warp_cuda.over_budget_tiles(self.dev)
            print(f'{self.name}: split warp over-budget tiles {over}',
                  flush=True)
            check(over == 0, f'{self.name}: {over} split-warp tiles over '
                  'the budget')
        return False


def serve_phase(dev):
    """The main path at full width. Returns the launch counts."""
    from pose_tpu_torch import serve
    from pose_tpu_torch.ops import stem, warp_cuda

    rng = np.random.RandomState(SEED + 2)
    frames, homs, ext = make_frames(rng, N_FRAMES, CANVAS, SIDE, True)
    intr = np.tile(np.array([[1000., 0, 128], [0, 1000., 128], [0, 0, 1]],
                            np.float32), (B, 1, 1))
    predictor = serve.Predictor(serve.default_args(), 'rgb', batch_size=B,
                                device=dev, seed=SEED)
    pre = serve.GatedPreprocessor(SIDE, device=dev)

    warp_cuda.split_warp.launches = 0
    stem.stem_conv.launches = 0
    batch_ms, answers, batches = [], [], []
    with NoTilesOverBudget('serve', dev), serve.BatchingServer(
            predictor, max_delay_ms=50.0) as server:
        for i in range(0, N_FRAMES, B):
            t0 = time.perf_counter()
            crops = pre(frames[i:i + B], homs[i:i + B], ext[i:i + B])
            futs = [server.submit(c) for c in crops]
            answers.append([f.result(timeout=300) for f in futs])
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            batches.append(crops)
        served, n_batches = server.served, server.batches
    direct = [predictor.predict_crops(c) for c in batches]
    absolute = predictor.predict_absolute(batches[0], intr)
    torch.cuda.synchronize()
    launches = {'split_warp': warp_cuda.split_warp.launches,
                'stem_conv': stem.stem_conv.launches}

    print(f'serve: {served} requests in {n_batches} batches, '
          f'{pre.split_batches} split-warp batches, {pre.mxu_batches} mxu '
          f'batches; first batch {batch_ms[0]:.2f} ms, median of the other '
          f'{len(batch_ms) - 1} {np.median(batch_ms[1:]):.2f} ms per batch '
          f'(warp + batching + forward + decode, host clock; per batch '
          f'{", ".join(f"{t:.2f}" for t in batch_ms)})', flush=True)
    check(served == N_FRAMES and n_batches == N_FRAMES // B,
          f'served {served} in {n_batches} batches')
    check(pre.mxu_batches == 0 and pre.split_batches == N_FRAMES // B,
          'every serving batch should pass the split gate')
    check(launches['split_warp'] == pre.split_batches,
          f'split_warp launched {launches["split_warp"]} times for '
          f'{pre.split_batches} warped batches')
    # the Predictor's bf16 forwards: 8 served batches, 8 predict_crops and
    # predict_absolute's
    print(f'serve: stem kernel launches {launches["stem_conv"]}', flush=True)
    check(launches['stem_conv'] > 0, 'the stem kernel was not launched on '
          'the serving path')
    worst = {'relat_cam': 0.0, 'spec_mat': 0.0}
    for got, ref in zip(answers, direct):
        for j, ans in enumerate(got):
            for k in worst:
                check(ans[k].shape == ref[k][j].shape, f'{k} shape')
                check(np.all(np.isfinite(ans[k])), f'{k} not finite')
                worst[k] = max(worst[k],
                               float(np.abs(ans[k] - ref[k][j]).max()))
    print(f'serve: BatchingServer vs predict_crops max diff relat_cam '
          f'{worst["relat_cam"]:.3g} mm, spec_mat {worst["spec_mat"]:.3g} px',
          flush=True)
    # the same crops in the same batch shape through the same forward
    check(worst['relat_cam'] <= 0.05 and worst['spec_mat'] <= 0.005,
          f'BatchingServer answers differ from predict_crops: {worst}')
    check(absolute.shape == (B, 19, 3) and np.all(np.isfinite(absolute)),
          f'predict_absolute {absolute.shape}')
    check(direct[0]['relat_cam'].shape == (B, 19, 3)
          and direct[0]['spec_mat'].shape == (B, 19, 2), 'output shapes')
    serve_breakdown(predictor, frames, homs, ext)
    return launches


def serve_breakdown(predictor, frames, homs, ext):
    """Where a served batch's time goes, measured after the main path (its
    launches are not counted): host-clock medians of the gated warp and of
    the forward + decode, then one batch under torch.profiler for the
    device's busy time and its largest kernels."""
    from pose_tpu_torch import serve

    pre = serve.GatedPreprocessor(SIDE, device=predictor.device)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    pre_ms, fwd_ms = [], []
    for _ in range(3):
        for i in range(0, N_FRAMES, B):
            crops, t = timed(lambda: pre(frames[i:i + B], homs[i:i + B],
                                         ext[i:i + B]))
            pre_ms.append(t)
            fwd_ms.append(timed(lambda: predictor.predict_crops(crops))[1])
    wall, busy, kernels = profile_step(lambda: predictor.predict_crops(
        pre(frames[:B], homs[:B], ext[:B])))
    print(f'breakdown: gated warp {np.median(pre_ms):.2f} ms, forward + '
          f'decode {np.median(fwd_ms):.2f} ms (host clock, medians of '
          f'{len(pre_ms)}); profiled batch: device busy {busy:.2f} ms of '
          f'{wall:.2f} ms wall ({100 * busy / wall:.1f}%, profiler on, '
          f'{sum(n for _, n in kernels.values())} device events)',
          flush=True)
    for name, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f'  {t:8.3f} ms  {n:4d}x  {name[:100]}', flush=True)


def device_ms(launches, iters, flush=None):
    """Median device time in ms of one call of each launcher, from the
    profiler's CUDA records over `iters` rounds under one profiler
    (the kernels' own time, without the host time of their wrappers).
    `launches` maps a name to (launch, match, per_call): launch() makes
    `per_call` distinct kernels whose names contain `match`; its time is
    the sum of their medians. With `flush`, the L2 is overwritten before
    every call."""
    for fn, _, _ in launches.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the profiler's CUDA records now and then miss launches (49, once 29,
    # of 50 seen on the card): the rounds are run again under a new
    # profiler, 3 times at most, until each kernel has records of 0.8 *
    # iters calls; each kernel's median over the records kept, summed over
    # the call's kernels
    records = {name: {} for name in launches}
    for attempt in range(1, 4):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                for fn, _, _ in launches.values():
                    if flush is not None:
                        flush.zero_()
                    fn()
            torch.cuda.synchronize()
        cuda = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        for name, (_, match, _) in launches.items():
            for e in cuda:
                if match in e.name:
                    records[name].setdefault(e.name, []).append(
                        e.time_range.elapsed_us() / 1e3)
        counts = {name: sorted(len(v) for v in by_kernel.values())
                  for name, by_kernel in records.items()}
        if any(len(records[name]) > per_call or counts[name][-1:] >
               [attempt * iters] for name, (_, _, per_call) in
               launches.items()):
            seen = sorted({e.name[:80] for e in cuda})
            raise RuntimeError(f'chip_smoke: profiler saw {counts} kernels '
                               f'for {attempt} x {iters} calls of '
                               f'{list(launches)}; device events seen: '
                               f'{seen}')
        if all(len(records[name]) == per_call and counts[name][0]
               >= 0.8 * iters for name, (_, _, per_call) in
               launches.items()):
            return {name: float(sum(np.median(v) for v in by_kernel.values()))
                    for name, by_kernel in records.items()}
    raise RuntimeError(f'chip_smoke: the profiler kept {counts} records of '
                       f'3 x {iters} calls')


def profile_step(fn):
    """fn() under torch.profiler, ending in a synchronize: (wall ms, busy
    ms, {kernel name: (ms, count)}) of the device events."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    return wall, sum(t for t, _ in kernels.values()), kernels


def host_ms(fn, n=3):
    """Host-clock ms of fn() to a synchronize: the first call apart, then
    the median of n more."""
    out = []
    for _ in range(n + 1):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out[0], float(np.median(out[1:]))


def bn_work(m, c, size, relu, res):
    """Bytes each fused-BN kernel must move (each input read once, each
    output written once; partials not counted) and the f32 operations it
    does, at (M, C) with `size`-byte activations. Returns {kernel: (bytes,
    flops)}."""
    mc = m * c
    return {
        # read x; read gamma, beta; write sums (2C) and coef (5C)
        'fused_bn_stats': (mc * size + 2 * c * 4 + 7 * c * 4, 3 * mc),
        # read x [+ res], scale, shift; write y
        'fused_bn_apply': (mc * size * (2 + res) + 2 * c * 4,
                           mc * (2 + res + relu)),
        # read x, dy [, y], mean, rstd, gamma; write sums and coef
        'fused_bn_bwd_sums': (mc * size * (2 + relu) + 10 * c * 4,
                              mc * (4 + relu)),
        # read x, dy [, y], a, c2, c3; write dx [, dres]
        'fused_bn_dx': (mc * size * (3 + relu + res) + 3 * c * 4,
                        mc * (4 + relu)),
    }


def bound_of(n_bytes, n_flops, flop_rate=F32_FLOP_PER_S):
    """(bound ms, 'bytes' or 'operations') against the card's memory rate
    and its rate for the operations' type (f32 outside the tensor cores by
    default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def fused_bn_phase(dev):
    """Kernel phase of the four fused-BN kernels at the step's shapes."""
    import torch.nn.functional as F

    from pose_tpu_torch.ops import fused_bn, fused_bn_cuda as K

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    names = list(K.KERNELS)
    errs = {k: 0.0 for k in names}
    times = {}
    for shape_name, n, hw, c, relu, has_res in BN_SHAPES:
        m = n * hw * hw
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape, scale=1.0, shift=0.0):
                return (torch.randn(*shape, generator=g, device=dev) * scale
                        + shift)
            x = rnd(m, c, scale=2.0, shift=0.5).to(dtype)
            res = rnd(m, c).to(dtype) if has_res else None
            dy = rnd(m, c).to(dtype)
            # under half_acc the BN parameters reach the kernel as bf16
            gamma = (torch.rand(c, generator=g, device=dev) + 0.5).to(dtype)
            beta = rnd(c).to(dtype)
            tag = f'{shape_name} {str(dtype)[6:]}'
            xf = x.float()
            sums, coef = K.stats(x, gamma, beta, 1e-5)
            plain_sums = fused_bn.channel_sums_plain(x)
            scale_s = torch.stack([xf.abs().sum(0), (xf * xf).sum(0)])
            coef_ref = fused_bn.stats_coef(sums, m, gamma, beta, 1e-5)
            mean, _, rstd, scale, shift = coef
            y = K.apply(x, res, scale, shift, relu)
            y_ref = fused_bn.apply_plain(x, res, scale, shift, relu)
            ym = y if relu else None
            bsums, bcoef = K.bwd_sums(x, dy, ym, mean, rstd, gamma)
            dyf = fused_bn._masked_dy(dy, ym)
            plain_bsums = fused_bn.bwd_sums_plain(x, dy, ym, mean)
            bscale = torch.stack([dyf.abs().sum(0),
                                  (dyf * (xf - mean)).abs().sum(0)])
            bcoef_ref = fused_bn.bwd_coef(bsums, m, gamma, mean, rstd)
            a, c2, c3, _, _ = bcoef
            dx, dres = K.dx(x, dy, ym, a, c2, c3, has_res)
            dx_ref, dres_ref = fused_bn.dx_plain(x, dy, ym, a, c2, c3,
                                                 has_res)
            torch.cuda.synchronize()
            ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23

            def ulps(got, ref):
                d = (got.float() - ref.float()).abs()
                return float((d / (ulp * ref.float().abs() + 1e-30)).max())

            def sums_ratio(got, ref, scl):
                return float(((got - ref).abs() / (scl + 1e-30)).max())

            def coef_ratio(got, ref):
                return float(((got - ref).abs()
                              / ref.abs().amax(1, keepdim=True)).max())

            checks = {
                'stats sums': (sums_ratio(sums, plain_sums, scale_s),
                               SUM_TOL),
                'stats coef': (coef_ratio(coef, coef_ref), COEF_TOL),
                'apply y (ulps)': (ulps(y, y_ref), 1.0),
                'bwd sums': (sums_ratio(bsums, plain_bsums, bscale),
                             SUM_TOL),
                'bwd coef': (coef_ratio(bcoef, bcoef_ref), COEF_TOL),
                'dx (ulps)': (ulps(dx, dx_ref), 1.0),
            }
            if has_res:
                checks['dres exact'] = (float((dres.float()
                                               - dres_ref.float()).abs()
                                              .max()), 0.0)
            print(f'fused_bn {tag}: ' + ', '.join(
                f'{k} {v:.3g} (tol {t:g})' for k, (v, t) in checks.items()),
                flush=True)
            for k, (v, t) in checks.items():
                check(v <= t, f'fused_bn {tag}: {k} {v} > {t}')
            errs['fused_bn_stats'] = max(errs['fused_bn_stats'], float(
                (sums - plain_sums).abs().max()))
            errs['fused_bn_apply'] = max(errs['fused_bn_apply'], float(
                (y.float() - y_ref.float()).abs().max()))
            errs['fused_bn_bwd_sums'] = max(errs['fused_bn_bwd_sums'], float(
                (bsums - plain_bsums).abs().max()))
            errs['fused_bn_dx'] = max(errs['fused_bn_dx'], float(
                (dx.float() - dx_ref.float()).abs().max()))

            # times: the kernels alone (bare launches into preallocated
            # outputs), L2 flushed; the plain versions and the library
            # yardstick between CUDA events, L2 flushed
            part = torch.empty((K.groups(m, c, dtype), 2, c),
                               dtype=torch.float32, device=dev)
            o_sums = torch.empty_like(sums)
            o_coef = torch.empty_like(coef)
            o_y, o_dx = torch.empty_like(x), torch.empty_like(x)
            o_dres = torch.empty_like(x) if has_res else None
            bare = {
                'fused_bn_stats': (lambda: K.launch_stats(
                    x, gamma, beta, 1e-5, part, o_sums, o_coef),
                    'fbn_stats_', 2),
                'fused_bn_apply': (lambda: K.launch_apply(
                    x, res, o_y, scale, shift, relu), 'fbn_apply_', 1),
                'fused_bn_bwd_sums': (lambda: K.launch_bwd_sums(
                    x, dy, ym, mean, rstd, gamma, part, o_sums, o_coef),
                    'fbn_bwd_', 2),
                'fused_bn_dx': (lambda: K.launch_dx(
                    x, dy, ym, o_dx, o_dres, a, c2, c3), 'fbn_dx_', 1),
            }
            plain = {
                'fused_bn_stats': lambda: fused_bn.stats_coef(
                    fused_bn.channel_sums_plain(x), m, gamma, beta, 1e-5),
                'fused_bn_apply': lambda: fused_bn.apply_plain(
                    x, res, scale, shift, relu),
                'fused_bn_bwd_sums': lambda: fused_bn.bwd_coef(
                    fused_bn.bwd_sums_plain(x, dy, ym, mean), m, gamma,
                    mean, rstd),
                'fused_bn_dx': lambda: fused_bn.dx_plain(
                    x, dy, ym, a, c2, c3, has_res),
            }
            # F.batch_norm (cuDNN or ATen's kernel) on the same activations
            # as a channels_last (N, C, H, W) tensor, f32 affine
            x4 = x.view(n, hw, hw, c).permute(0, 3, 1, 2)
            dy4 = dy.view(n, hw, hw, c).permute(0, 3, 1, 2)
            w32, b32 = gamma.float().clone(), beta.float().clone()
            lib_fwd = time_ms(lambda: F.batch_norm(
                x4, None, None, w32, b32, training=True, eps=1e-5), 10,
                flush)
            x4g = x4.detach().requires_grad_()
            w32.requires_grad_()
            b32.requires_grad_()
            y4 = F.batch_norm(x4g, None, None, w32, b32, training=True,
                              eps=1e-5)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                y4, (x4g, w32, b32), dy4, retain_graph=True), 10, flush)
            work = bn_work(m, c, x.element_size(), relu, has_res)
            kernel_times = device_ms(bare, 20, flush)
            for k in names:
                ms = kernel_times[k]
                p_ms = time_ms(plain[k], 5, flush)
                fwd = k in ('fused_bn_stats', 'fused_bn_apply')
                lib = lib_fwd if fwd else lib_bwd
                pair = 'stats+apply' if fwd else 'bwd_sums+dx'
                bound, by = bound_of(*work[k])
                times[(k, tag)] = (ms, p_ms, lib, bound, by)
                print(f'  {k} {tag}: kernel {ms:.5f} ms, plain {p_ms:.4f} '
                      f'ms, bound {bound:.5f} ms by {by} ({work[k][0]} B, '
                      f'{work[k][1]} flop), {bound / ms * 100:.1f}% of the '
                      f'bound; F.batch_norm {"forward" if fwd else "backward"}'
                      f' {lib:.4f} ms (the whole {pair} pair)',
                      flush=True)
    out = []
    for k in names:
        ms, p_ms, lib, bound, by = times[(k, 'stem bfloat16')]
        out.append(dict(name=k, route='cuda',
                        source='pose_tpu_torch/csrc/fused_bn.cu',
                        replaces=REPLACES[k], max_abs_err=errs[k], ms=ms,
                        plain_ms=p_ms, bound_ms=bound, bound_by=by,
                        library_ms=lib))
    return out


REPLACES = {'fused_bn_stats': 'pose_tpu/ops/fused_bn.py:78',
            'fused_bn_apply': 'pose_tpu/ops/fused_bn.py:91',
            'fused_bn_bwd_sums': 'pose_tpu/ops/fused_bn.py:154',
            'fused_bn_dx': 'pose_tpu/ops/fused_bn.py:174',
            'split_warp_depth': 'pose_tpu/ops/warp_pallas.py:231',
            'banded_warp': 'pose_tpu/ops/warp_pallas.py:113',
            'full_warp': 'pose_tpu/ops/warp_pallas.py:50',
            'renorm_fwd': 'pose_tpu/ops/partial_conv.py:38',
            'renorm_bwd': 'pose_tpu/ops/partial_conv.py:49',
            'stem_conv': 'pose_tpu/ops/stem_pallas.py:63'}


def depth_canvases(gen, n, dev):
    """n raw-depth canvases (n, 424, 512, 1) f32 on the card, metres in
    [0.5, 4.5], with about 10 % zero pixels (a Kinect v2 frame's missing
    returns), and their (n, 2) extents."""
    d = torch.rand((n, DEPTH_H, DEPTH_W, 1), generator=gen, device=dev)
    d = 0.5 + 4.0 * d
    holes = torch.rand((n, DEPTH_H, DEPTH_W, 1), generator=gen, device=dev)
    d[holes < 0.1] = 0.0
    ext = torch.tensor([[DEPTH_H, DEPTH_W]], dtype=torch.int32,
                       device=dev).expand(n, 2).contiguous()
    return d, ext


def split_warp_depth_phase(dev):
    """Kernel phase of the split warp's depth instantiation (C = 1, f32
    canvases and weights) at the depth stream's shape: 64 canvases of
    424 x 512 -> 257^2."""
    from pose_tpu_torch.ops import warp, warp_cuda

    rng = np.random.RandomState(SEED + 6)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    m = warp.split_defaults((SIDE, SIDE))[0]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    canvases, extents = depth_canvases(gen, DEPTH_B, dev)
    homs = realistic_homs(rng, DEPTH_B, DEPTH_H, SIDE)
    check(warp.split_band_ok(homs, (SIDE, SIDE)),
          'depth homographies must pass the split gate')
    residual, scale = warp.decompose_homography(
        torch.as_tensor(homs).to(dev), (SIDE, SIDE), m)
    args = (canvases, residual, scale, extents, (SIDE, SIDE), m, 1.0,
            torch.float32)
    out = staged_vs_direct(args, 'depth')
    ref = warp_cuda.split_warp_plain(*args)
    torch.cuda.synchronize()
    check(out.shape == (DEPTH_B, 1, SIDE, SIDE), f'depth split output '
          f'{tuple(out.shape)}')
    check(bool(torch.isfinite(out).all()), 'depth split non-finite')
    err = float((out - ref).abs().max())
    # metres up to 4.5: the kernel's tolerance on [0, 1] values times 4.5
    tol = 4.5 * KERNEL_TOL
    print(f'split_warp depth (64, 424, 512, 1) f32 -> 257^2: max_abs_err '
          f'{err:.3g} m (tol {tol:g})', flush=True)
    check(err <= tol, f'depth split disagrees with its plain version: {err}')
    t = split_timing(canvases, residual, scale, extents, m, 1.0,
                     torch.float32, flush)
    print(f'split_warp depth: kernel {t["ms"]:.5f} ms (L2 flushed), plain '
          f'{t["plain_ms"]:.4f} ms, bound {t["bound_ms"]:.5f} ms by '
          f'{t["bound_by"]} ({t["n_bytes"]} B: {t["read"]} canvas pixels '
          f'read of {DEPTH_B * DEPTH_H * DEPTH_W}; {t["n_flops"]} flop); '
          f'{100 * t["bound_ms"] / t["ms"]:.1f} % of the bound', flush=True)
    return dict(name='split_warp_depth', route='cuda',
                source='pose_tpu_torch/csrc/split_warp.cu',
                replaces=REPLACES['split_warp_depth'], max_abs_err=err,
                ms=t['ms'], plain_ms=t['plain_ms'], bound_ms=t['bound_ms'],
                bound_by=t['bound_by'], library_ms=None)


def admitted_homs(rng, n, canvas, side_in, band=32):
    """n realistic crop homographies of a canvas x canvas frame that
    band_ok_v2 admits one by one on the whole canvas, and how many were
    drawn to find them."""
    from pose_tpu_torch.ops import warp_cuda

    found, drawn = [], 0
    while len(found) < n:
        h = realistic_homs(rng, 1, canvas, side_in)
        drawn += 1
        if warp_cuda.band_ok_v2(h, (canvas, canvas), (side_in, side_in),
                                band=band):
            found.append(h[0])
    return np.stack(found), drawn


def banded_warp_phase(dev):
    """Kernel phases of the banded kernel and the full-scanline oracle:
    the banded kernel at stage B of the split warp, (64, C, 256, 256) f32
    -> 257^2 for the depth stream (C = 1) and colour (C = 3), and both
    kernels on whole 512^2 colour canvases whose crops band_ok_v2 admits,
    where the banded kernel is also held against the oracle kernel."""
    from pose_tpu_torch.ops import warp, warp_banded, warp_cuda

    rng = np.random.RandomState(SEED + 7)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    m = warp.split_defaults((SIDE, SIDE))[0]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    full_m = torch.full((DEPTH_B, 2), m, dtype=torch.int32, device=dev)
    rows = {}
    stage_b = {}
    for n_ch in (1, 3):
        if n_ch == 1:
            canvases, extents = depth_canvases(gen, DEPTH_B, dev)
            homs = realistic_homs(rng, DEPTH_B, DEPTH_H, SIDE)
            wdtype, post = torch.float32, 1.0
        else:
            frames, homs, ext = make_frames(rng, DEPTH_B, CANVAS, SIDE, True)
            canvases = torch.as_tensor(frames).to(dev)
            extents = torch.as_tensor(ext).to(dev)
            wdtype, post = torch.bfloat16, 1.0 / 255.0
        residual, scale = warp.decompose_homography(
            torch.as_tensor(homs).to(dev), (SIDE, SIDE), m)
        inter = warp.scale_resample_planar(canvases, scale, extents, m,
                                           wdtype, post).contiguous()
        out = warp_banded.banded_warp(inter, residual, full_m, (SIDE, SIDE),
                                      planar_in=True)
        ref = warp_banded.banded_warp_plain(inter, residual, full_m,
                                            (SIDE, SIDE), planar_in=True)
        torch.cuda.synchronize()
        scl = float(ref.abs().max())
        err = float((out - ref).abs().max())
        tol = KERNEL_TOL * max(scl, 1.0)
        check(bool(torch.isfinite(out).all()), 'banded warp non-finite')
        check(err <= tol, f'banded warp C={n_ch} disagrees with its plain '
              f'version: {err} > {tol}')
        scal = warp_banded.pack_scalars(residual, full_m)
        ms = kernel_ms(lambda: warp_banded.launch_banded(inter, scal, out,
                                                         True),
                       'banded_warp_kernel', 50, flush)
        plain_ms = time_ms(lambda: warp_banded.banded_warp_plain(
            inter, residual, full_m, (SIDE, SIDE), planar_in=True), 5, flush)
        n_bytes, n_flops, read = two_pass_work(residual, (m, m),
                                               (SIDE, SIDE), full_m, n_ch,
                                               4, 11)
        bound, by = bound_of(n_bytes, n_flops)
        all_bytes = (DEPTH_B * n_ch * (m * m + SIDE * SIDE) * 4)
        print(f'banded_warp stage B (64, {n_ch}, {m}, {m}) f32 -> 257^2: '
              f'max_abs_err {err:.3g} (tol {tol:.3g}); kernel {ms:.5f} ms '
              f'(L2 flushed), plain {plain_ms:.4f} ms, bound {bound:.5f} ms '
              f'by {by} ({n_bytes} B: {int(read.sum())} of '
              f'{DEPTH_B * m * m} intermediate pixels read; all of it would '
              f'be {all_bytes} B, {all_bytes / HBM_BYTES_PER_S * 1e3:.5f} '
              f'ms)', flush=True)
        stage_b[n_ch] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                             by=by)
        del inter, out, ref

    # whole canvases: crops the gate admits, colour f32 (the pallas_banded
    # colour path) through the banded kernel, uint8 through the oracle
    homs, drawn = admitted_homs(rng, DEPTH_B, CANVAS, SIDE)
    full0 = warp_banded.full_warp.launches
    frames = rng.randint(0, 256, (DEPTH_B, CANVAS, CANVAS, 3),
                         dtype=np.uint8)
    u8 = torch.as_tensor(frames).to(dev)
    f32 = (u8.to(torch.float32) / 255.0).contiguous()
    homs_t = torch.as_tensor(homs).to(dev)
    ext = torch.full((DEPTH_B, 2), CANVAS, dtype=torch.int32, device=dev)
    check(warp_cuda.band_ok_v2(homs, (CANVAS, CANVAS), (SIDE, SIDE)),
          'admitted crops must pass the banded gate as a batch')
    banded = warp_banded.banded_warp(f32, homs_t, ext, (SIDE, SIDE))
    banded_ref = warp_banded.banded_warp_plain(f32, homs_t, ext,
                                               (SIDE, SIDE))
    oracle_f32 = warp_banded.full_warp(f32, homs_t, ext, (SIDE, SIDE))
    oracle = warp_banded.full_warp(u8, homs_t, ext, (SIDE, SIDE))
    oracle_ref = warp_banded.full_warp_plain(u8, homs_t, ext, (SIDE, SIDE))
    torch.cuda.synchronize()
    err_b = float((banded - banded_ref).abs().max())
    err_o = float((oracle - oracle_ref).abs().max())
    same = torch.equal(banded, oracle_f32)
    print(f'whole 512^2 canvases, {DEPTH_B} admitted crops of {drawn} drawn:'
          f' banded vs plain {err_b:.3g} (tol {KERNEL_TOL:g}); oracle uint8 '
          f'vs plain {err_o:.3g} (tol {255 * KERNEL_TOL:g}); banded == '
          f'oracle on the f32 canvases: {same}', flush=True)
    check(err_b <= KERNEL_TOL, f'banded warp on canvases: {err_b}')
    check(err_o <= 255 * KERNEL_TOL, f'oracle warp: {err_o}')
    check(same, 'banded and oracle kernels differ on an admitted batch')
    scal = warp_banded.pack_scalars(homs_t, ext)
    times = device_ms({
        'banded': (lambda: warp_banded.launch_banded(f32, scal, banded,
                                                     False),
                   'banded_warp_kernel', 1),
        'oracle': (lambda: warp_banded.launch_full(u8, scal, oracle),
                   'full_warp_kernel', 1)}, 20, flush)
    plain_o = time_ms(lambda: warp_banded.full_warp_plain(
        u8, homs_t, ext, (SIDE, SIDE)), 3, flush)
    n_bytes, n_flops, read = two_pass_work(homs_t, (CANVAS, CANVAS),
                                           (SIDE, SIDE), ext, 3, 1, 11)
    bound_o, by_o = bound_of(n_bytes, n_flops)
    f32_bytes = n_bytes + int(read.sum()) * 3 * 3     # 4-byte pixels
    bound_b, _ = bound_of(f32_bytes, n_flops)
    print(f'whole canvases: banded kernel (f32 NHWC) {times["banded"]:.5f} '
          f'ms, bound {bound_b:.5f} ms; oracle kernel (uint8) '
          f'{times["oracle"]:.5f} ms, plain {plain_o:.4f} ms, bound '
          f'{bound_o:.5f} ms by {by_o} ({n_bytes} B: {int(read.sum())} '
          f'canvas pixels read of {DEPTH_B * CANVAS * CANVAS})', flush=True)
    d = stage_b[1]
    rows['banded_warp'] = dict(
        name='banded_warp', route='cuda',
        source='pose_tpu_torch/csrc/banded_warp.cu',
        replaces=REPLACES['banded_warp'],
        max_abs_err=max(stage_b[1]['err'], stage_b[3]['err'], err_b),
        ms=d['ms'], plain_ms=d['plain_ms'], bound_ms=d['bound'],
        bound_by=d['by'], library_ms=None)
    rows['full_warp'] = dict(
        name='full_warp', route='cuda',
        source='pose_tpu_torch/csrc/banded_warp.cu',
        replaces=REPLACES['full_warp'], max_abs_err=err_o,
        ms=times['oracle'], plain_ms=plain_o, bound_ms=bound_o,
        bound_by=by_o, library_ms=None,
        launches=warp_banded.full_warp.launches - full0)
    return rows


def partial_layers(dev):
    """The 22 partial convolutions of the partial_depth ResNet-50 at 257^2:
    (name, module, input shape at batch 64), from one forward at batch 1
    with hooks."""
    from pose_tpu_torch.models import build_model
    from pose_tpu_torch.models.resnet import PartialConv2d
    from pose_tpu_torch.train import default_depth_args

    model = build_model(default_depth_args(partial_conv=True,
                                           depth_only=True),
                        'partial_depth').to(dev).eval()
    seen = []
    hooks = [mod.register_forward_hook(
        lambda mod, inp, out, name=name: seen.append(
            (name, mod, (DEPTH_B,) + tuple(inp[0].shape[1:]))))
        for name, mod in model.named_modules()
        if isinstance(mod, PartialConv2d)]
    with torch.no_grad():
        model(torch.rand(1, 1, SIDE, SIDE, device=dev))
    for h in hooks:
        h.remove()
    return seen


def renorm_phase(dev):
    """Kernel phase of the renorm pair at the 22 partial-conv shapes of the
    partial_depth ResNet-50 at batch 64, bf16 and f32: each layer through
    partial_conv(use_pallas=True) (the kernels, via RenormFn) forward and
    backward, against the same layer with the plain renorm (cuDNN held to
    its deterministic algorithms, so the two runs may be held to the same
    bits); then each distinct output shape's kernels alone, with their
    plain versions and bounds."""
    from pose_tpu_torch.ops import partial_conv as pc

    layers = partial_layers(dev)
    check(len(layers) == 22, f'{len(layers)} partial convolutions, not 22')
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    launches0 = {k: f.launches for k, f in pc.KERNELS.items()}
    errs = {'renorm_fwd': 0.0, 'renorm_bwd': 0.0}
    out_shapes = {}
    try:
        for dtype in (torch.bfloat16, torch.float32):
            for name, mod, shape in layers:
                x = torch.randn(shape, generator=g, device=dev).to(dtype)
                x = x.contiguous(memory_format=torch.channels_last)
                mask = (torch.rand((shape[0], 1) + shape[2:], generator=g,
                                   device=dev) > 0.1).to(dtype)
                w = mod.weight.detach().to(dtype)
                res = []
                for use_pallas in (True, False):
                    xx = x.clone().requires_grad_()
                    out, mout = pc.partial_conv(
                        xx, mask, w, mod.stride, mod.padding, mod.dilation,
                        use_pallas=use_pallas)
                    if use_pallas:
                        grad = torch.randn(out.shape, generator=g,
                                           device=dev).to(dtype)
                    out.backward(grad)
                    res.append((out.detach(), mout, xx.grad))
                (o1, m1, g1), (o2, m2, g2) = res
                errs['renorm_fwd'] = max(
                    errs['renorm_fwd'], float((o1.float() - o2.float()).abs()
                                              .max()),
                    float((m1.float() - m2.float()).abs().max()))
                errs['renorm_bwd'] = max(
                    errs['renorm_bwd'],
                    float((g1.float() - g2.float()).abs().max()))
                out_shapes.setdefault(tuple(o1.shape), []).append(name)
                del x, mask, res, o1, o2, g1, g2, grad
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    launches = {k: f.launches - launches0[k] for k, f in pc.KERNELS.items()}
    print(f'renorm: 22 partial convs x bf16/f32 through partial_conv('
          f'use_pallas=True) against the plain renorm, forward and backward:'
          f' max_abs_err out/mask {errs["renorm_fwd"]:.3g}, d_x '
          f'{errs["renorm_bwd"]:.3g} (tol 0: the same bits); kernel '
          f'launches {launches}', flush=True)
    for k, v in errs.items():
        check(v == 0.0, f'{k} differs from the plain renorm: {v}')
    check(launches == {'renorm_fwd': 44, 'renorm_bwd': 44},
          f'renorm launches {launches}, expected 44 each')

    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        total = {'renorm_fwd': [0.0, 0.0, 0.0], 'renorm_bwd': [0.0, 0.0,
                                                               0.0]}
        for shape, names in out_shapes.items():
            b, c, h, w = shape
            size = torch.finfo(dtype).bits // 8
            raw = torch.randn(shape, generator=g, device=dev).to(
                dtype).contiguous(memory_format=torch.channels_last)
            mask_raw = torch.randint(0, 50, (b, 1, h, w), generator=g,
                                     device=dev).to(dtype)
            out, mout = torch.empty_like(raw), torch.empty_like(mask_raw)
            k = device_ms({
                'renorm_fwd': (lambda: pc.launch_fwd(raw, mask_raw, out,
                                                     mout, 49.0),
                               'renorm_fwd_kernel', 1),
                'renorm_bwd': (lambda: pc.launch_bwd(raw, mask_raw, out,
                                                     49.0),
                               'renorm_bwd_kernel', 1)}, 20, flush)
            rows_c = b * h * w
            work = {'renorm_fwd': (2 * rows_c * c * size + 2 * rows_c * size,
                                   rows_c * c + 5 * rows_c),
                    'renorm_bwd': (2 * rows_c * c * size + rows_c * size,
                                   rows_c * c + 4 * rows_c)}
            plain = {'renorm_fwd': lambda: pc.renormalize_xla(
                         raw, mask_raw, 49.0),
                     'renorm_bwd': lambda: pc.renorm_bwd_plain(
                         raw, mask_raw, 49.0)}
            for kname in ('renorm_fwd', 'renorm_bwd'):
                p_ms = time_ms(plain[kname], 5, flush)
                bound, by = bound_of(*work[kname])
                times[(kname, shape, dtype)] = (k[kname], p_ms, bound, by)
                n = len(names)
                total[kname][0] += n * k[kname]
                total[kname][1] += n * p_ms
                total[kname][2] += n * bound
                print(f'  {kname} {str(dtype)[6:]} {shape} x{n}: kernel '
                      f'{k[kname]:.5f} ms, plain {p_ms:.4f} ms, bound '
                      f'{bound:.5f} ms by {by} ({work[kname][0]} B), '
                      f'{bound / k[kname] * 100:.1f}% of the bound',
                      flush=True)
            del raw, mask_raw, out, mout
        for kname, (t_k, t_p, t_b) in total.items():
            print(f'renorm {kname} {str(dtype)[6:]}, the 22 layers of one '
                  f'forward (or backward): kernels {t_k:.4f} ms, plain '
                  f'{t_p:.4f} ms, bound {t_b:.4f} ms', flush=True)
    stem = (DEPTH_B, 64, (SIDE + 1) // 2, (SIDE + 1) // 2)
    out_rows = []
    for kname in ('renorm_fwd', 'renorm_bwd'):
        ms, p_ms, bound, by = times[(kname, stem, torch.bfloat16)]
        out_rows.append(dict(
            name=kname, route='cuda',
            source='pose_tpu_torch/csrc/partial_conv.cu',
            replaces=REPLACES[kname], max_abs_err=errs[kname], ms=ms,
            plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=None,
            launches=launches[kname]))
    return out_rows


def joint_batch_small(rng, b, side, joints, n_ch):
    """A joint+track batch at a small size: random image channels, GT at
    about 3 m, a labelled key joint."""
    valid = rng.rand(b, joints) > 0.2
    valid[:, 2] = True
    return dict(
        image=rng.randn(b, side, side, n_ch).astype(np.float32),
        true_cam=(rng.uniform(-300, 300, (b, joints, 3))
                  + [0, 0, 3000]).astype(np.float32),
        true_mat=rng.uniform(5, side - 5, (b, joints, 2)).astype(np.float32),
        true_val=valid,
        intrinsics=np.tile(np.array([[500., 0, side / 2],
                                     [0, 500., side / 2], [0, 0, 1]],
                                    np.float32), (b, 1, 1)))


def train_reference_phase(dev):
    """Two joint+track steps of a small f32 bn_impl='pallas' model (basic
    blocks, layers (1,1,1,1), 65^2, stride 32, 4 input channels) on the
    card (kernels, cuDNN with TF32 off) and on the CPU (plain versions),
    from the same weights and batch, at the flagship learn rate. f32
    convolutions and sums in another order: losses within 1e-4 relative,
    running statistics within 1e-4 of their largest value, parameters
    within 2 * lr * steps (an Adam step moves an element by ~lr, and one
    whose gradient is ~0 may move either way)."""
    from pose_tpu_torch.models import PoseResNet, init_weights
    from pose_tpu_torch.train import default_train_args, steps

    lr = 2e-5
    args = default_train_args(model='resnet18', side_in=65, stride=32,
                              depth=4, num_joints=5, half_acc=False,
                              bn_impl='pallas', learn_rate=lr)
    batch = joint_batch_small(np.random.RandomState(SEED + 4), 4, 65, 5, 4)
    res = {}
    for device in (dev, torch.device('cpu')):
        model = PoseResNet(block='basic', layers=(1, 1, 1, 1),
                           in_channels=4, stride=32, num_joints=5, depth=4,
                           joint_space=True, bn_impl='pallas')
        init_weights(model, torch.Generator().manual_seed(SEED))
        model.to(device, memory_format=torch.channels_last)
        state = steps.init_state(model, args)
        step = steps.make_joint_train_step(args, 2, do_track=True)
        tb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        outs = [step(state, tb, lr) for _ in range(2)]
        res[device.type] = ([{k: float(v) for k, v in o.items()}
                             for o in outs],
                            {k: v.detach().cpu() for k, v in
                             model.state_dict().items()})
    (l_gpu, s_gpu), (l_cpu, s_cpu) = res['cuda'], res['cpu']
    loss_err = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(l_gpu, l_cpu)
                   for k in a)
    stat_err = max(float((s_gpu[k] - v).abs().max() / v.abs().max())
                   for k, v in s_cpu.items()
                   if k.endswith(('running_mean', 'running_var')))
    par_err = max(float((s_gpu[k] - v).abs().max()) for k, v in s_cpu.items()
                  if v.is_floating_point() and 'running' not in k)
    print(f'reference (card vs CPU, two joint+track steps, pallas BN): '
          f'losses {loss_err:.3g} rel (tol 1e-4), running stats '
          f'{stat_err:.3g} of max (tol 1e-4), params {par_err:.3g} '
          f'(tol {4 * lr:g})', flush=True)
    check(all(np.isfinite(v) for o in l_gpu for v in o.values()),
          'train reference: non-finite loss')
    check(loss_err <= 1e-4, f'train reference losses differ: {loss_err}')
    check(stat_err <= 1e-4, f'train reference stats differ: {stat_err}')
    check(par_err <= 4 * lr, f'train reference params differ: {par_err}')


class TrainBatches:
    """The train phase's batches, made as the loader makes them: seeded
    512^2 uint8 frames and crop homographies through the gated split warp
    (GatedPreprocessor), the bbox-mask 4th channel from each crop's GT
    box, synthetic GT (joints about 3 m deep, projected with seeded crop
    intrinsics). Frames and GT are drawn up front (set-up); the warp and
    the mask run as each batch is taken. A CUDA event is recorded on the
    stream as each batch is taken, so consecutive events bracket one
    step's work on the card."""

    def __init__(self, rng, n_batches, pre, args):
        self.pre, self.args = pre, args
        self.items = []
        b, side, joints = TRAIN_B, args.side_in, args.num_joints
        for _ in range(n_batches):
            frames, homs, ext = make_frames(rng, b, CANVAS, side, True)
            root = np.stack([rng.uniform(-200, 200, b),
                             rng.uniform(-200, 200, b),
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
            valid = rng.rand(b, joints) > 0.1
            valid[:, 2] = True
            self.items.append(dict(
                frames=frames, homs=homs, ext=ext,
                quads=quads.astype(np.float32),
                true_cam=cam.astype(np.float32),
                true_mat=mat.astype(np.float32), true_val=valid,
                intrinsics=intr.astype(np.float32)))
        self.events = []

    def __len__(self):
        return len(self.items)

    def batch(self, it):
        from pose_tpu_torch.data import augment

        crops = self.pre(it['frames'], it['homs'], it['ext'])
        mask = augment.bbox_mask_channel(
            torch.as_tensor(it['quads']).to(crops.device), self.args.side_in)
        out = {k: it[k] for k in ('true_cam', 'true_mat', 'true_val',
                                  'intrinsics')}
        out['image'] = torch.cat([crops, mask], -1)
        return out

    def __iter__(self):
        for it in self.items:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            yield self.batch(it)


def train_phase(dev):
    """The training main path at full width. Returns the launch counts."""
    from pose_tpu_torch import serve
    from pose_tpu_torch.models import build_model, init_weights
    from pose_tpu_torch.ops import fused_bn, fused_bn_cuda, warp_cuda
    from pose_tpu_torch.train import (CMU_KEY_INDEX, default_train_args,
                                      engine)

    args = default_train_args(bn_impl='pallas', batch_size=TRAIN_B)
    rng = np.random.RandomState(SEED + 5)
    pre = serve.GatedPreprocessor(args.side_in, device=dev)
    epochs = [TrainBatches(rng, TRAIN_STEPS, pre, args) for _ in range(2)]
    extra = TrainBatches(rng, 1, pre, args).items[0]
    model = init_weights(build_model(args),
                         torch.Generator().manual_seed(SEED))
    info = engine.JointInfo(None, None, None, CMU_KEY_INDEX)
    trainer = engine.RgbTrainer(args, model, info, device=dev)
    watch = ['conv1.weight', 'layer4.0.bn2.weight', 'cam_regressor.bias',
             'bn1.running_mean', 'layer4.0.bn2.running_var']
    before = {k: v.detach().clone()
              for k, v in trainer.model.state_dict().items() if k in watch}
    kernels = {'split_warp': warp_cuda.split_warp, **fused_bn_cuda.KERNELS}

    for fn in kernels.values():
        fn.launches = 0
    fused_bn.dy_rows.copies = 0
    t0 = time.perf_counter()
    records = []
    with NoTilesOverBudget('train', dev):
        for epoch, batches in enumerate(epochs, start=1):
            records.append(trainer.train(epoch, batches))
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            batches.events.append(end)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    dy_copies = fused_bn.dy_rows.copies

    step_ms = [b.events[i].elapsed_time(b.events[i + 1])
               for b in epochs for i in range(len(b.events) - 1)]
    rest = float(np.median(step_ms[1:]))
    n_steps = 2 * TRAIN_STEPS
    print(f'train: {n_steps} steps at batch {TRAIN_B} (bn_impl=pallas, '
          f'half_acc, 257^2, ResNet-50): first step {step_ms[0]:.2f} ms, '
          f'median of the other {n_steps - 1} {rest:.2f} ms per step '
          f'({TRAIN_B / rest * 1e3:.1f} img/s; CUDA events on the stream '
          f'between batches: warp + mask + forward + backward + update; '
          f'per step {", ".join(f"{t:.2f}" for t in step_ms)}); wall '
          f'{wall:.2f} s for both epochs incl. console syncs', flush=True)
    print(f'train: records {records}', flush=True)
    print(f'train: launches {launches}, dy layout copies {dy_copies}, '
          f'split batches {pre.split_batches}, mxu batches '
          f'{pre.mxu_batches}', flush=True)
    for rec in records:
        check(all(np.isfinite(v) for v in rec.values()),
              f'non-finite train loss: {rec}')
    check(records[1]['recon_train_loss'] > 0 and
          records[0]['recon_train_loss'] == 0.0,
          'the track loss must be on in epoch 2 only')
    after = trainer.model.state_dict()
    for k in watch:
        check(not torch.equal(after[k], before[k]), f'{k} did not move')
    for k in fused_bn_cuda.KERNELS:
        check(launches[k] == N_BN * n_steps, f'{k} launched {launches[k]} '
              f'times, expected {N_BN} x {n_steps}')
    check(pre.mxu_batches == 0 and launches['split_warp'] ==
          pre.split_batches == n_steps,
          f'split_warp launched {launches["split_warp"]} times for '
          f'{pre.split_batches} warped batches')
    check(dy_copies == 0, f'{dy_copies} dy layout copies')
    train_breakdown(trainer, epochs[0], extra, args, dev)
    return launches


def train_breakdown(trainer, batches, item, args, dev):
    """One profiled pallas step after the main path (its launches are not
    counted): the card's busy share, its largest entries and the four BN
    kernels' total; then the same step's time with bn_impl='xla'."""
    from pose_tpu_torch.models import build_model, init_weights
    from pose_tpu_torch.train import CMU_KEY_INDEX, engine, steps

    batch = trainer._place(batches.batch(item), ('image', 'true_cam',
                                                 'true_val', 'true_mat',
                                                 'intrinsics'))
    step = steps.make_joint_train_step(args, CMU_KEY_INDEX, True)
    step(trainer.state, batch, 1e-5)
    torch.cuda.synchronize()
    wall, busy, kernels = profile_step(lambda: step(trainer.state, batch,
                                                    1e-5))
    bn = sum(t for k, (t, _) in kernels.items() if 'fbn_' in k)
    # the fused kernels are the step's only BN: no cuDNN or ATen BN kernel
    library_bn = [k for k in kernels if 'fbn_' not in k and any(
        t in k.lower() for t in ('batch_norm', 'batchnorm', 'bn_fw', 'bn_bw'))]
    check(not library_bn, f'library BN kernels ran on the main path: '
          f'{library_bn}')
    print(f'train breakdown: profiled pallas step, device busy {busy:.2f} '
          f'ms of {wall:.2f} ms wall ({100 * busy / wall:.1f}%, profiler '
          f'on, {sum(n for _, n in kernels.values())} device events); the '
          f'four BN kernels {bn:.2f} ms ({100 * bn / busy:.1f}% of busy)',
          flush=True)
    for name, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f'  {t:8.3f} ms  {n:4d}x  {name[:100]}', flush=True)

    pallas_ms = host_ms(lambda: step(trainer.state, batch, 1e-5))
    xla_args = type(args)(**dict(vars(args), bn_impl='xla'))
    model = init_weights(build_model(xla_args),
                         torch.Generator().manual_seed(SEED))
    xla = engine.RgbTrainer(xla_args, model,
                            engine.JointInfo(None, None, None, CMU_KEY_INDEX),
                            device=dev)
    xla_ms = host_ms(lambda: step(xla.state, batch, 1e-5))
    print(f'train breakdown: one step, host clock to a synchronize, the '
          f'first apart: bn_impl=pallas {pallas_ms[0]:.2f} then median '
          f'{pallas_ms[1]:.2f} ms; bn_impl=xla {xla_ms[0]:.2f} then median '
          f'{xla_ms[1]:.2f} ms (ReferenceBatchNorm in plain torch, the '
          f'breakdown only)',
          flush=True)
    del xla
    torch.cuda.empty_cache()


def depth_reference_phase(dev):
    """A small distillation step (fusion teacher with bn_impl='pallas',
    depth student on colour, -attention) and a small partial_depth vanilla
    step (-partial_conv -depth_only) of f32 models on the card against the
    CPU, from the same weights and batch, two steps each. f32 convolutions
    and sums in another order: losses within 1e-4 relative, running
    statistics (the teacher's drifted ones too) within 1e-4 of their
    largest value, parameters within 2 * lr * steps."""
    from pose_tpu_torch.models import PoseResNet, init_weights
    from pose_tpu_torch.train import default_depth_args, steps

    rng = np.random.RandomState(SEED + 9)
    batch = dict(color=rng.randn(4, 65, 65, 3).astype(np.float32),
                 depth=rng.uniform(0.02, 0.45, (4, 65, 65, 1)).astype(
                     np.float32),
                 true_cam=(rng.uniform(-300, 300, (4, 5, 3))
                           + [0, 0, 3000]).astype(np.float32),
                 true_val=rng.rand(4, 5) > 0.2,
                 atten_map=rng.rand(4, 3, 3, 1).astype(np.float32))
    batch['depth'][rng.rand(4, 65, 65, 1) < 0.1] = 0.0
    batch['in_image'] = batch['depth']
    kw = dict(block='basic', layers=(1, 1, 1, 1), stride=32, num_joints=5,
              depth=4, bn_impl='pallas')
    common = dict(model='resnet18', side_in=65, stride=32, depth=4,
                  num_joints=5, half_acc=False, bn_impl='pallas')
    cases = {
        'distill': default_depth_args(do_teach=True, do_fusion=True,
                                      attention=True, **common),
        'partial_depth': default_depth_args(partial_conv=True,
                                            depth_only=True, **common)}
    for mode, args in cases.items():
        lr = args.learn_rate
        res = {}
        for device in (dev, torch.device('cpu')):
            if mode == 'distill':
                student = PoseResNet(variant='depth', **kw)
                teacher = init_weights(PoseResNet(variant='fusion', **kw),
                                       torch.Generator().manual_seed(SEED + 1))
                teacher.to(device, memory_format=torch.channels_last)
                step = steps.make_distill_train_step(args, 2, True, False)
            else:
                student = PoseResNet(variant='partial_depth', in_channels=1,
                                     **kw)
                step = steps.make_vanilla_train_step(args, 2)
            init_weights(student, torch.Generator().manual_seed(SEED))
            student.to(device, memory_format=torch.channels_last)
            state = steps.init_state(student, args)
            tb = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
            outs = [step(state, teacher, tb, lr, 0.1) if mode == 'distill'
                    else step(state, tb, lr) for _ in range(2)]
            states = [student.state_dict()]
            if mode == 'distill':
                states.append(teacher.state_dict())
            res[device.type] = ([{k: float(v) for k, v in o.items()}
                                 for o in outs],
                                [{k: v.detach().cpu() for k, v in sd.items()}
                                 for sd in states])
        (l_gpu, s_gpu), (l_cpu, s_cpu) = res['cuda'], res['cpu']
        loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                       for a, b in zip(l_gpu, l_cpu) for k in a
                       if k != 'semi_loss')
        stat_err = max(float((g[k] - v).abs().max() / v.abs().max())
                       for g, c in zip(s_gpu, s_cpu) for k, v in c.items()
                       if k.endswith(('running_mean', 'running_var')))
        par_err = max(float((s_gpu[0][k] - v).abs().max())
                      for k, v in s_cpu[0].items()
                      if v.is_floating_point() and 'running' not in k)
        print(f'depth reference (card vs CPU, two {mode} steps): losses '
              f'{loss_err:.3g} rel (tol 1e-4), running stats {stat_err:.3g} '
              f'of max (tol 1e-4), params {par_err:.3g} (tol {4 * lr:g})',
              flush=True)
        check(all(np.isfinite(v) for o in l_gpu for v in o.values()),
              f'{mode} reference: non-finite loss')
        check(loss_err <= 1e-4, f'{mode} reference losses differ: '
              f'{loss_err}')
        check(stat_err <= 1e-4, f'{mode} reference stats differ: {stat_err}')
        check(par_err <= 4 * lr, f'{mode} reference params differ: '
              f'{par_err}')


class DepthBatches:
    """The depth engine's batches, made as its loader makes them: seeded
    512^2 uint8 colour frames through the gated split warp
    (GatedPreprocessor), seeded 424 x 512 raw-depth canvases through
    process_depth_batch (the depth warp `depth_impl`, gated per batch with
    split_band_ok, the mxu warp for a batch the gate rejects), synthetic GT
    (17 joints about 3 m deep, projected with seeded crop intrinsics) and
    the -attention map of the GT's 2D positions. Frames, canvases and GT
    are drawn up front (set-up); the warps run as each batch is taken,
    with a CUDA event recorded on the stream at each batch. Counts what
    the whole-canvas banded path (`pallas_banded`) would have admitted."""

    def __init__(self, rng, gen, n_batches, pre, args, depth_impl,
                 color=True):
        from pose_tpu_torch.data.loader import attention_map

        dev = pre.device
        self.pre, self.args, self.depth_impl = pre, args, depth_impl
        self.color = color
        self.items, self.events = [], []
        self.split_batches = self.mxu_batches = 0
        self.banded_batches = self.banded_crops = self.crops = 0
        b, side, joints = DEPTH_B, args.side_in, args.num_joints
        for _ in range(n_batches):
            it = {}
            if color:
                it['frames'], it['homs'], it['ext'] = make_frames(
                    rng, b, CANVAS, side, True)
            it['canvases'], it['dext'] = depth_canvases(gen, b, dev)
            it['dhoms'] = realistic_homs(rng, b, DEPTH_H, side)
            root = np.stack([rng.uniform(-200, 200, b),
                             rng.uniform(-200, 200, b),
                             rng.uniform(2800, 3200, b)], -1)
            cam = root[:, None] + np.concatenate(
                [rng.uniform(-400, 400, (b, joints, 2)),
                 rng.uniform(-200, 200, (b, joints, 1))], -1)
            f = rng.uniform(450, 550, b)
            mat = (cam[..., :2] / cam[..., 2:]) * f[:, None, None] + side / 2
            valid = rng.rand(b, joints) > 0.1
            valid[:, H36M_KEY] = True
            it['atten_map'] = np.stack([
                attention_map(side, args.stride, mat[i], args.attention)
                for i in range(b)]).transpose(0, 2, 3, 1)
            it['true_cam'] = cam.astype(np.float32)
            it['true_val'] = valid
            k_inv = np.linalg.inv(np.array([[f.mean(), 0, side / 2],
                                            [0, f.mean(), side / 2],
                                            [0, 0, 1]]))
            it['k_invs'] = np.tile(k_inv, (b, 1, 1)).astype(np.float32)
            self.items.append(it)

    def __len__(self):
        return len(self.items)

    def batch(self, it):
        from pose_tpu_torch.data import augment
        from pose_tpu_torch.ops import warp, warp_cuda

        side, dev = self.args.side_in, self.pre.device
        impl = self.depth_impl
        if warp.split_band_ok(it['dhoms'], (side, side)):
            self.split_batches += 1
        else:
            impl = 'mxu'
            self.mxu_batches += 1
        for homs, hw in ((it['dhoms'], (DEPTH_H, DEPTH_W)),) + (
                ((it['homs'], (CANVAS, CANVAS)),) if self.color else ()):
            self.banded_batches += warp_cuda.band_ok_v2(homs, hw,
                                                        (side, side))
            self.banded_crops += sum(warp_cuda.band_ok_v2(
                h[None], hw, (side, side)) for h in homs)
            self.crops += len(homs)
        out = {k: it[k] for k in ('true_cam', 'true_val', 'atten_map')}
        out['depth'] = augment.process_depth_batch(
            it['canvases'], torch.as_tensor(it['dhoms']).to(dev), it['dext'],
            torch.as_tensor(it['k_invs']).to(dev),
            np.full(DEPTH_B, 0.1, np.float32), side, self.args.nexponent,
            self.args.to_depth, warp_impl=impl)
        if self.color:
            out['color'] = self.pre(it['frames'], it['homs'], it['ext'])
        return out

    def __iter__(self):
        for it in self.items:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            yield self.batch(it)

    def step_ms(self):
        return [self.events[i].elapsed_time(self.events[i + 1])
                for i in range(len(self.events) - 1)]


def depth_kernels():
    from pose_tpu_torch.ops import (fused_bn_cuda, partial_conv, stem,
                                    warp_banded, warp_cuda)
    return {'split_warp': warp_cuda.split_warp,
            'stem_conv': stem.stem_conv,
            'banded_warp': warp_banded.banded_warp,
            'full_warp': warp_banded.full_warp, **partial_conv.KERNELS,
            **fused_bn_cuda.KERNELS}


def read_launches(kernels):
    from pose_tpu_torch.ops import warp_cuda
    out = {k: fn.launches for k, fn in kernels.items() if k != 'split_warp'}
    by_ch = warp_cuda.split_warp.launches_by_channels
    out['split_warp'], out['split_warp_depth'] = by_ch[3], by_ch[1]
    return out


def zero_launches(kernels):
    from pose_tpu_torch.ops import warp_cuda
    for fn in kernels.values():
        fn.launches = 0
    warp_cuda.split_warp.launches_by_channels.update({1: 0, 3: 0})


def distill_phase(dev):
    """The depth stack's main path: DepthTrainer.train with -do_teach
    -do_fusion -attention and the ntu_train.sh flags, a fusion ResNet-50
    teacher and a depth ResNet-50 student on colour, both with
    bn_impl='pallas' and seeded weights, batch 64, two epochs of 4 steps;
    the depth stream through the split kernel at one channel in epoch 1
    and the two-kernel split warp (stage B the banded kernel) in epoch 2.
    Returns the launch counts."""
    from pose_tpu_torch import serve
    from pose_tpu_torch.models import build_model, init_weights
    from pose_tpu_torch.train import (default_depth_args, depth_engine,
                                      engine, schedules)

    args = default_depth_args(do_teach=True, do_fusion=True, attention=True,
                              bn_impl='pallas')
    student_args = type(args)(**dict(vars(args), depth_only=False))
    rng = np.random.RandomState(SEED + 10)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    pre = serve.GatedPreprocessor(args.side_in, device=dev)
    epochs = [DepthBatches(rng, gen, DEPTH_STEPS, pre, args, impl)
              for impl in ('split', 'split_pallas2')]
    teacher = init_weights(build_model(args, 'fusion'),
                           torch.Generator().manual_seed(SEED + 1))
    student = init_weights(build_model(student_args, 'depth'),
                           torch.Generator().manual_seed(SEED))
    info = engine.JointInfo(None, None, None, H36M_KEY)
    trainer = depth_engine.DepthTrainer(args, student, info, thresh=150.0,
                                        device=dev)
    trainer.set_teacher(teacher)
    watch = ['conv1.weight', 'layer4.0.bn2.weight', 'regressor.bias']
    t_watch = ['bn1.running_mean', 'fusion.bn.running_var',
               'layer4.0.bn1.running_mean']
    before = {k: v.detach().clone()
              for k, v in trainer.model.state_dict().items() if k in watch}
    t_before = {k: v.detach().clone() for k, v in teacher.state_dict().items()}
    kernels = depth_kernels()
    zero_launches(kernels)
    t0 = time.perf_counter()
    records = []
    with NoTilesOverBudget('distill', dev):
        for epoch, batches in enumerate(epochs, start=1):
            records.append(trainer.train(epoch, batches))
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            batches.events.append(end)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    step_ms = [t for b in epochs for t in b.step_ms()]
    rest = float(np.median(step_ms[1:]))
    n_steps = 2 * DEPTH_STEPS
    print(f'distill: {n_steps} steps at batch {DEPTH_B} (fusion ResNet-50 '
          f'teacher, depth ResNet-50 student, bn_impl=pallas, half_acc, '
          f'257^2, 17 joints): first step {step_ms[0]:.2f} ms, median of the'
          f' other {n_steps - 1} {rest:.2f} ms per step '
          f'({DEPTH_B / rest * 1e3:.1f} img/s; CUDA events on the stream '
          f'between batches: colour warp + depth warp + teacher forward + student forward, backward, update;'
          f' per step {", ".join(f"{t:.2f}" for t in step_ms)}); wall '
          f'{wall:.2f} s incl. console syncs', flush=True)
    print(f'distill: records {records}', flush=True)
    print(f'distill: launches {launches}; colour split batches '
          f'{pre.split_batches}, mxu {pre.mxu_batches}; depth gated split '
          f'batches {sum(b.split_batches for b in epochs)}, mxu '
          f'{sum(b.mxu_batches for b in epochs)}', flush=True)
    crops = sum(b.crops for b in epochs)
    print(f'distill: on the same batches the whole-canvas banded path '
          f'(pallas_banded, band_ok_v2 at band 32) would have admitted '
          f'{sum(b.banded_batches for b in epochs)} of {4 * DEPTH_STEPS} '
          f'batches (depth 424x512 and colour 512^2) and '
          f'{sum(b.banded_crops for b in epochs)} of {crops} single crops',
          flush=True)
    for rec in records:
        check(all(np.isfinite(v) for v in rec.values()),
              f'non-finite distill loss: {rec}')
        check(rec['dist_train_loss'] > 0, f'no distillation loss: {rec}')
    after = trainer.model.state_dict()
    for k in watch:
        check(not torch.equal(after[k], before[k]), f'student {k} did not '
              'move')
    t_after = teacher.state_dict()
    for k in t_watch:
        check(not torch.equal(t_after[k], t_before[k]),
              f'teacher {k} did not drift')
    check(all(torch.equal(t_after[k], v) for k, v in t_before.items()
              if 'running' not in k and 'num_batches' not in k),
          'teacher weights changed')
    split_d = epochs[0].split_batches
    check(launches['split_warp_depth'] == split_d > 0,
          f'depth split kernel launched {launches["split_warp_depth"]} times'
          f' for {split_d} gated batches')
    check(launches['banded_warp'] == epochs[1].split_batches > 0,
          f'banded kernel launched {launches["banded_warp"]} times for '
          f'{epochs[1].split_batches} gated batches')
    check(launches['split_warp'] == pre.split_batches > 0,
          f'colour split kernel launched {launches["split_warp"]} times')
    for k in ('fused_bn_stats', 'fused_bn_apply', 'fused_bn_bwd_sums',
              'fused_bn_dx'):
        check(launches[k] > 0, f'{k} not launched on the distill path')
    check(launches['full_warp'] == launches['renorm_fwd'] == 0,
          'kernels off the distill path were launched')
    # the teacher's bf16 forward under no_grad: conv1 (Cin 3) and conv2
    # (Cin 1) each step; the student's stem is recorded by autograd
    check(launches['stem_conv'] > 0, 'the stem kernel was not launched in '
          'the teacher\'s forwards')
    distill_breakdown(trainer, epochs[0],
                      schedules.depth_learn_rate(args, 2))
    return launches


def distill_breakdown(trainer, batches, lr):
    """Where a distill step's time goes, after the main path (its launches
    are not counted): host-clock medians of the batch's two warps, the
    teacher's forward alone and the whole step; then one profiled step for
    the card's busy share, its largest entries and the BN kernels' total."""
    from pose_tpu_torch.train import steps

    args = trainer.args
    it = batches.items[0]
    keys = ('color', 'depth', 'true_cam', 'true_val', 'atten_map')
    batch = trainer._place(batches.batch(it), keys)
    step = trainer._step('distill')
    dtype = steps.compute_dtype(args, trainer.model)
    _, color_ms = host_ms(lambda: batches.pre(it['frames'], it['homs'],
                                              it['ext']))
    prep = {}
    for impl in ('split', 'split_pallas2'):
        batches.depth_impl = impl
        _, prep[impl] = host_ms(lambda: batches.batch(it))
    teacher_in = tuple(steps.image_input(batch[k]) for k in ('color',
                                                             'depth'))

    def teacher_forward():
        with torch.no_grad():
            steps._apply(trainer.teacher, teacher_in, True, dtype)

    _, teach_ms = host_ms(teacher_forward)
    _, step_ms = host_ms(lambda: step(trainer.state, trainer.teacher, batch,
                                      lr, 0.1))
    wall, busy, kernels = profile_step(lambda: step(
        trainer.state, trainer.teacher, batch, lr, 0.1))
    bn = sum(t for k, (t, _) in kernels.items() if 'fbn_' in k)
    print(f'distill breakdown (host clock to a synchronize, medians of 3): '
          f'colour gated warp {color_ms:.2f} ms; one batch with the depth '
          f'warp split {prep["split"]:.2f} ms, split_pallas2 '
          f'{prep["split_pallas2"]:.2f} ms (both warps, GT upload); teacher '
          f'forward {teach_ms:.2f} ms of a {step_ms:.2f} ms step '
          f'({100 * teach_ms / step_ms:.1f}%); profiled step: device busy '
          f'{busy:.2f} ms of {wall:.2f} ms wall ({100 * busy / wall:.1f}%, '
          f'profiler on, {sum(n for _, n in kernels.values())} device '
          f'events); the four BN kernels {bn:.2f} ms ({100 * bn / busy:.1f}% '
          f'of busy)', flush=True)
    for name, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f'  {t:8.3f} ms  {n:4d}x  {name[:100]}', flush=True)


def partial_depth_phase(dev):
    """-partial_conv -depth_only: DepthTrainer.vanilla_train of a
    partial_depth ResNet-50 (bn_impl='pallas' for its non-partial BNs),
    batch 64, 4 steps, the depth stream through the split kernel at one
    channel. Returns the launch counts."""
    from pose_tpu_torch import serve
    from pose_tpu_torch.models import build_model, init_weights
    from pose_tpu_torch.train import (default_depth_args, depth_engine,
                                      engine)

    args = default_depth_args(partial_conv=True, depth_only=True,
                              bn_impl='pallas')
    rng = np.random.RandomState(SEED + 11)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    pre = serve.GatedPreprocessor(args.side_in, device=dev)
    batches = DepthBatches(rng, gen, DEPTH_STEPS, pre, args, 'split',
                           color=False)
    model = init_weights(build_model(args, 'partial_depth'),
                         torch.Generator().manual_seed(SEED + 2))
    trainer = depth_engine.DepthTrainer(
        args, model, engine.JointInfo(None, None, None, H36M_KEY),
        device=dev)
    kernels = depth_kernels()
    zero_launches(kernels)
    with NoTilesOverBudget('partial_depth', dev):
        rec = trainer.train(1, batches)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        batches.events.append(end)
        torch.cuda.synchronize()
    launches = read_launches(kernels)
    step_ms = batches.step_ms()
    rest = float(np.median(step_ms[1:]))
    print(f'partial_depth: {DEPTH_STEPS} vanilla steps at batch {DEPTH_B} '
          f'(ResNet-50, 22 partial convs with the plain renorm, half_acc): '
          f'first step {step_ms[0]:.2f} ms, median of the other '
          f'{len(step_ms) - 1} {rest:.2f} ms ({DEPTH_B / rest * 1e3:.1f} '
          f'img/s; per step {", ".join(f"{t:.2f}" for t in step_ms)}); '
          f'record {rec}; launches {launches}', flush=True)
    check(np.isfinite(rec['cam_train_loss']), f'non-finite loss {rec}')
    check(launches['split_warp_depth'] == batches.split_batches > 0,
          'the depth split kernel was not launched on the partial path')
    check(launches['fused_bn_stats'] > 0, 'fused BN not launched')
    # its stem is a partial convolution (no StemConv), and the train step
    # records autograd
    check(launches['stem_conv'] == 0, 'the stem kernel ran on the '
          'partial_depth path')
    batch = trainer._place(batches.batch(batches.items[0]),
                           ('depth', 'true_cam', 'true_val'))
    batch['in_image'] = batch.pop('depth')
    step = trainer._step('vanilla')
    _, step_ms = host_ms(lambda: step(trainer.state, batch, 1e-5))
    wall, busy, kernels = profile_step(lambda: step(trainer.state, batch,
                                                    1e-5))
    print(f'partial_depth breakdown: one step {step_ms:.2f} ms (host clock '
          f'to a synchronize, median of 3); profiled step: device busy '
          f'{busy:.2f} ms of {wall:.2f} ms wall ({100 * busy / wall:.1f}%, '
          f'{sum(n for _, n in kernels.values())} device events)',
          flush=True)
    for name, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f'  {t:8.3f} ms  {n:4d}x  {name[:100]}', flush=True)
    return launches


def stem_work(x, out_dtype):
    """Bytes (the bf16 input and weights read once, the NHWC output written
    once) and operations (2 per multiply-add) of the stem conv on x."""
    b, cin, h, w = x.shape
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out_size = torch.finfo(out_dtype).bits // 8
    n_bytes = x.numel() * 2 + 49 * cin * 64 * 2 + b * oh * ow * 64 * out_size
    return n_bytes, 2 * b * oh * ow * 64 * 49 * cin


def stem_phase(dev):
    """Kernel phase of the stem conv at the test epoch's shape, (64, Cin,
    257, 257) bf16 with seeded weights for Cin = 4 (the extra-channel stem),
    3 and 1 (the distillation teacher's conv1 and conv2), and at the serving
    shape (8, 4, 257, 257): stem_conv_fwd on the padded planar input (f32
    out) and the model route on the channels_last input (bf16 out) against
    the plain version, the bf16 output against the rounded f32 output; then
    the kernel alone, its plain version, cuDNN's bf16 F.conv2d and the
    bound."""
    import torch.nn.functional as F

    from pose_tpu_torch.ops import stem

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    err, shapes = 0.0, {}
    for b, cin in ((TRAIN_B, 4), (TRAIN_B, 3), (TRAIN_B, 1), (B, 4)):
        x = torch.randn((b, cin, SIDE, SIDE), generator=g,
                        device=dev).to(torch.bfloat16)
        w = (torch.randn((7, 7, cin, 64), generator=g, device=dev)
             * 0.05).to(torch.bfloat16)
        x_cl = x.contiguous(memory_format=torch.channels_last)
        out = stem.stem_conv_fwd(stem.pad_planar(x, SIDE), w, SIDE)
        out_bf = stem.stem_conv(x_cl, w, torch.bfloat16)
        oihw = w.permute(3, 2, 0, 1)
        ref = stem.stem_conv_plain(x, oihw).permute(0, 2, 3, 1)
        mag = stem.stem_conv_plain(x.abs(), oihw.abs()).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), 'stem_conv non-finite')
        ratio = float(((out - ref).abs() / (mag + 1e-30)).max())
        cin_err = float((out - ref).abs().max())
        same = torch.equal(out_bf, out.to(torch.bfloat16))
        err = max(err, cin_err)
        tol = stem_tol(cin)
        del ref, mag
        o32 = torch.empty_like(out)
        o16 = torch.empty_like(out_bf)
        # an earlier checkout's kernel takes the (7, 7, Cin, 64) weight
        wp = stem.pack_weight(w) if hasattr(stem, 'pack_weight') else w
        ms32 = kernel_ms(lambda: stem.launch(x, wp, o32), 'stem_conv_kernel',
                         20, flush)
        ms16 = kernel_ms(lambda: stem.launch(x_cl, wp, o16),
                         'stem_conv_kernel', 20, flush)
        plain_ms = time_ms(lambda: stem.stem_conv_plain(x_cl, oihw), 10,
                           flush)
        oihw_cl = oihw.contiguous(memory_format=torch.channels_last)
        lib_ms = time_ms(lambda: F.conv2d(x_cl, oihw_cl, stride=2,
                                          padding=3), 10, flush)
        b32 = bound_of(*stem_work(x, torch.float32), BF16_FLOP_PER_S)
        b16 = bound_of(*stem_work(x, torch.bfloat16), BF16_FLOP_PER_S)
        print(f'stem_conv ({b}, {cin}, {SIDE}, {SIDE}) bf16: max_abs_err '
              f'{cin_err:.3g}, {ratio:.3g} of sum |terms| (tol {tol:.3g} = '
              f'{49 * cin} * 2^-23); bf16 out == rounded f32 out: {same}; '
              f'kernel {ms32:.5f} ms (planar in, f32 out; bound {b32[0]:.5f} '
              f'ms by {b32[1]}), {ms16:.5f} ms (channels_last in, bf16 out, '
              f'the model route; bound {b16[0]:.5f} ms by {b16[1]}, '
              f'{100 * b16[0] / ms16:.1f} % of it); plain {plain_ms:.4f} ms;'
              f' cuDNN bf16 F.conv2d {lib_ms:.4f} ms', flush=True)
        check(ratio <= tol, f'stem_conv Cin={cin} disagrees with its plain '
              f'version: {ratio} > {tol}')
        check(same, f'stem_conv Cin={cin}: bf16 output is not the rounded '
              'f32 output')
        shapes[f'{b}x{cin}x{SIDE}^2'] = dict(
            ms=ms16, ms_f32_out=ms32, plain_ms=plain_ms, bound_ms=b16[0],
            bound_by=b16[1], library_ms=lib_ms, ratio=ratio, tol=tol)
        del x, x_cl, out, out_bf, o32, o16
    main = shapes[f'{TRAIN_B}x4x{SIDE}^2']
    return dict(name='stem_conv', route='cuda',
                source='pose_tpu_torch/csrc/stem_conv.cu',
                replaces=REPLACES['stem_conv'], max_abs_err=err,
                ms=main['ms'], plain_ms=main['plain_ms'],
                bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                library_ms=main['library_ms'], shapes=shapes)


def torchvision_state(path):
    """A seeded ResNet-50 ImageNet state dict with torchvision's keys (the
    trunk, its BN statistics, a 1000-way fc) for -pretrain, written to
    `path`."""
    from pose_tpu_torch.models import build_model, init_weights
    from pose_tpu_torch.train import default_train_args

    g = torch.Generator().manual_seed(SEED + 13)
    trunk = init_weights(build_model(default_train_args(
        extra_channel=False, joint_space=False)), g)
    state = {k: v for k, v in trunk.state_dict().items()
             if not k.startswith('cam_regressor')}
    for k, v in state.items():
        if k.endswith(('running_mean', 'bias')):
            v.normal_(0.0, 0.1, generator=g)
        elif k.endswith('running_var'):
            v.uniform_(0.5, 1.5, generator=g)
    state['fc.weight'] = torch.randn((1000, 2048), generator=g) * 0.01
    state['fc.bias'] = torch.zeros(1000)
    torch.save(state, path)


def cli_flags(meta, save, model_path):
    """cmu_train.sh's flags on the fixture store, 2 epochs; the decode pool
    as wide as the host."""
    return ['-extra_channel', '-half_acc', '-shuffle', '-save_record',
            '-pretrain', '-static_filter', '-joint_space', '-do_track',
            '-model', 'resnet50', '-model_path', model_path, '-suffix',
            'smoke', '-data_name', 'cmu', '-save_path', save, '-criterion',
            'SmoothL1', '-batch_size', str(TRAIN_B), '-learn_rate', '2e-5',
            '-n_cudas', '1', '-n_epochs', '2', '-metadata_path', meta,
            '-workers', str(os.cpu_count() or 1)]


def spec_line(rec):
    return ('=>[SPEC] cam_mean: %1.3f  [pck]: %1.3f  [auc]: %1.3f'
            % (rec['cam_mean'], rec['score_pck'], rec['score_auc']))


def entry_phase(dev, tmp):
    """The entry point's main path: pose_tpu_torch.main with cmu_train.sh's
    flags and POSE_TPU_BN=pallas on a seeded CMU-style store of Panoptic HD
    JPEG frames, -pretrain from a seeded torchvision-key ResNet-50, two
    epochs (4 train steps and a test epoch of 2 batches each; track from
    epoch 2), then -val_only on the same save path. Returns the launch
    counts of the two epochs."""
    from pose_tpu_torch import main as cli
    from pose_tpu_torch.data import synthetic
    from pose_tpu_torch.models import build_model, convert, init_weights
    from pose_tpu_torch.ops import fused_bn_cuda, stem, warp_cuda
    from pose_tpu_torch.train import CMU_KEY_INDEX, steps

    t0 = time.perf_counter()
    meta = synthetic.make_cmu_fixture(
        os.path.join(tmp, 'store'), ENTRY_TRAIN, ENTRY_VALID, seed=SEED,
        imshape=ENTRY_HD, workers=os.cpu_count() or 1)
    model_path = os.path.join(tmp, 'resnet50.pth')
    torchvision_state(model_path)
    save = os.path.join(tmp, 'save')
    argv = cli_flags(meta, save, model_path)
    report = {}
    probe = init_weights(build_model(cli.opts.parse(argv)),
                         torch.Generator().manual_seed(0))
    convert.load_pretrained(probe, cli.opts.parse(argv), report=report)
    setup_s = time.perf_counter() - t0
    heads = {k for k in probe.state_dict() if 'regressor' in k}
    print(f'entry: store of {ENTRY_TRAIN} train and {2 * ENTRY_VALID} valid/'
          f'test {ENTRY_HD[0]}x{ENTRY_HD[1]} JPEG frames and the -pretrain '
          f'state written in {setup_s:.1f} s; -pretrain filled '
          f'{len(report["filled"])} keys, missing {sorted(report["missing"])},'
          f' unused {sorted(report["unused"])}', flush=True)
    check(set(report['missing']) == heads, f'-pretrain left '
          f'{report["missing"]} at their init, not just the heads')
    check(report['unused'] == {'fc.weight', 'fc.bias'},
          f'-pretrain unused keys {report["unused"]}')
    del probe

    kernels = {'split_warp': warp_cuda.split_warp, 'stem_conv':
               stem.stem_conv, **fused_bn_cuda.KERNELS}
    bn = os.environ.get('POSE_TPU_BN')
    os.environ['POSE_TPU_BN'] = 'pallas'
    try:
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with NoTilesOverBudget('entry', dev):
            run = cli.main(argv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        val = cli.main([a for a in argv if a != '-save_record']
                       + ['-val_only'])
    finally:
        if bn is None:
            os.environ.pop('POSE_TPU_BN')
        else:
            os.environ['POSE_TPU_BN'] = bn
    train_l, test_l = run.train_loader, run.test_loader
    train_ms = [t for i in range(2) for t in train_l.step_ms(i)]
    test_ms = [t for i in range(2) for t in test_l.step_ms(i)]
    decode = ([t for e in train_l.log for t in e['decode_ms']]
              + [t for e in test_l.log for t in e['decode_ms']])
    n_steps = len(train_ms)
    best = run.logger.state['best_epoch']
    print(f'entry: {n_steps} train steps and {len(test_ms)} test batches at '
          f'batch {TRAIN_B} (ResNet-50, bn_impl=pallas, half_acc, 257^2) in '
          f'{wall:.2f} s: train step median {np.median(train_ms):.2f} ms '
          f'(first {train_ms[0]:.2f}; per step '
          f'{", ".join(f"{t:.2f}" for t in train_ms)}), test batch median '
          f'{np.median(test_ms):.2f} ms (per batch '
          f'{", ".join(f"{t:.2f}" for t in test_ms)}; CUDA events on the '
          f'stream between batches: warp + mask + step); host decode median '
          f'{np.median(decode):.1f} ms per batch of {TRAIN_B} on one of '
          f'{os.cpu_count()} worker threads (max {max(decode):.1f})',
          flush=True)
    print(f'entry: warps train {dict(train_l.impl_counts)}, test '
          f'{dict(test_l.impl_counts)}; launches {launches}; best epoch '
          f'{best}; records train {run.train}, test {run.test}', flush=True)
    trained_spec, val_spec = spec_line(run.test[best - 1]), spec_line(
        val.test[0])
    print(f'entry: trained {trained_spec} | -val_only {val_spec}',
          flush=True)
    check(trained_spec == val_spec, '-val_only SPEC line differs from the '
          'trained run\'s best epoch')
    for rec in run.train + run.test + val.test:
        check(all(np.isfinite(v) for v in rec.values()),
              f'non-finite record {rec}')
    check(run.train[1]['recon_train_loss'] > 0
          and run.train[0]['recon_train_loss'] == 0.0,
          'the track loss must be on in epoch 2 only')
    check(n_steps == 2 * ENTRY_TRAIN // TRAIN_B
          and len(test_ms) == 2 * ENTRY_VALID // TRAIN_B,
          f'{n_steps} steps and {len(test_ms)} test batches')
    for name in ('model_1.pth', 'model_2.pth', 'best.pth',
                 'train_record.pth'):
        check(os.path.exists(os.path.join(save, 'resnet50-smoke', name)),
              f'{name} not written')
    split = train_l.impl_counts['split']
    check(launches['split_warp'] == split > 0, f'split_warp launched '
          f'{launches["split_warp"]} times for {split} gated train batches')
    for k in fused_bn_cuda.KERNELS:
        check(launches[k] == N_BN * n_steps, f'{k} launched {launches[k]} '
              f'times, expected {N_BN} x {n_steps}')
    check(launches['stem_conv'] == len(test_ms),
          f'stem_conv launched {launches["stem_conv"]} times for '
          f'{len(test_ms)} test batches')
    entry_breakdown(run, dev)
    return launches


def entry_breakdown(run, dev):
    """After the main path (launches not counted): one profiled test batch
    (the eval forward with the root solve) for the card's busy share and
    largest entries, and one profiled train step, which must launch no
    stem kernel."""
    from pose_tpu_torch.ops import recon, stem

    trainer = run.trainer
    keys = ('image', 'true_cam', 'true_val', 'true_mat', 'intrinsics')
    it = iter(run.test_loader)
    batch = trainer._place(next(it), keys)
    it.close()

    def test_batch():
        out = trainer._eval_step(trainer.state, batch)
        recon.recon_root(out['spec_mat'], out['relat_cam'],
                         batch['intrinsics'])

    test_batch()
    wall, busy, kernels = profile_step(test_batch)
    print(f'entry breakdown: profiled test batch, device busy {busy:.2f} ms '
          f'of {wall:.2f} ms wall ({100 * busy / wall:.1f}%, profiler on, '
          f'{sum(n for _, n in kernels.values())} device events)',
          flush=True)
    for name, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f'  {t:8.3f} ms  {n:4d}x  {name[:100]}', flush=True)
    check(any('stem_conv_kernel' in k for k in kernels),
          'no stem kernel in the profiled test batch')

    it = iter(run.train_loader)
    batch = trainer._place(next(it), keys)
    it.close()
    step = trainer._get_joint_step(True)
    before = stem.stem_conv.launches
    wall, busy, kernels = profile_step(lambda: step(trainer.state, batch,
                                                    1e-5))
    stem_in_step = [k for k in kernels if 'stem_conv' in k]
    print(f'entry breakdown: profiled train step, device busy {busy:.2f} ms '
          f'of {wall:.2f} ms wall ({100 * busy / wall:.1f}%); stem kernel '
          f'launches in it {stem.stem_conv.launches - before}', flush=True)
    check(stem.stem_conv.launches == before and not stem_in_step,
          f'the stem kernel ran in a train step: {stem_in_step}')


def main(argv):
    """No arguments: every phase. `--only split,split_depth,stem`: the
    build and those kernel phases, then their rows, and no result line."""
    only = []
    if argv[:1] == ['--only'] and len(argv) == 2:
        only = argv[1].split(',')
    elif argv:
        print('usage: chip_smoke.py [--only split,split_depth,stem]',
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on an '
              'NVIDIA GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pose_tpu_torch import cuda_build, runtime
    from pose_tpu_torch.ops import (fused_bn_cuda, partial_conv, stem,
                                    warp_banded, warp_cuda)

    dev = runtime.resolve_device('cuda')
    print(card_line(), flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}', flush=True)

    t0 = time.perf_counter()
    built = cuda_build.compile_sources(['split_warp', 'fused_bn',
                                        'banded_warp', 'partial_conv',
                                        'stem_conv'])
    for mod in (warp_cuda, fused_bn_cuda, warp_banded, partial_conv, stem):
        mod.build()
    print(f'build: {", ".join(f"{k}.cu {v:.1f} s" for k, v in built.items())}'
          f' (in parallel; {time.perf_counter() - t0:.1f} s in all)',
          flush=True)

    if only:
        # kernel phases alone, for measuring a kernel between full runs
        phases = {'split': split_warp_phase, 'split_depth':
                  split_warp_depth_phase, 'stem': stem_phase}
        rows = [phases[p](dev) for p in only]
        print(json.dumps({'kernels': rows}))
        return 0
    kernels = [split_warp_phase(dev)] + fused_bn_phase(dev)
    depth_rows = [split_warp_depth_phase(dev)]
    banded = banded_warp_phase(dev)
    depth_rows += [banded['banded_warp'], banded['full_warp']]
    depth_rows += renorm_phase(dev)
    stem_row = stem_phase(dev)
    reference_phase(dev)
    train_reference_phase(dev)
    depth_reference_phase(dev)
    serve_launches = serve_phase(dev)
    check(serve_launches['split_warp'] > 0, 'split_warp was not launched '
          'on the serving path')
    launches = train_phase(dev)
    for k in kernels:
        k['launches'] = launches[k['name']]
        check(k['launches'] > 0, f'{k["name"]} was not launched on the '
              'training path')
    distill = distill_phase(dev)
    for k in depth_rows:
        # the depth path's kernels count their distill-path launches; the
        # oracle and the renorm pair (off the path) their kernel phases'
        if k['name'] in ('split_warp_depth', 'banded_warp'):
            k['launches'] = distill[k['name']]
            check(k['launches'] > 0, f'{k["name"]} was not launched on the '
                  'distill path')
    partial = partial_depth_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        entry = entry_phase(dev, tmp)
    # the split and stem kernels run on several paths: each path's count,
    # and their sum as the row's launches
    by_path = {'split_warp': {'serve': serve_launches['split_warp'],
                              'train': launches['split_warp'],
                              'distill': distill['split_warp'],
                              'entry': entry['split_warp']},
               'split_warp_depth': {'distill': distill['split_warp_depth'],
                                    'partial_depth':
                                        partial['split_warp_depth']},
               'stem_conv': {'serve': serve_launches['stem_conv'],
                             'distill': distill['stem_conv'],
                             'partial_depth': partial['stem_conv'],
                             'entry': entry['stem_conv']}}
    kernels += depth_rows + [stem_row]
    for k in kernels:
        if k['name'] in by_path:
            k['launches_by_path'] = by_path[k['name']]
            k['launches'] = sum(by_path[k['name']].values())
    check(entry['stem_conv'] > 0, 'stem_conv was not launched on the entry '
          'point\'s test epochs')

    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
