"""Chip smoke test of the PyTorch/CUDA port (pose_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py
    python3 chip_smoke.py --only split,split_depth,stem,banded,int8
    python3 chip_smoke.py --only resume,threads
    python3 chip_smoke.py --only export

`--only` also runs from the root of an earlier checkout whose wrappers
predate staged split tiles and the packed stem weight (no
warp_cuda.launch_direct, no stem.pack_weight), or the fused int8 conv (no
int8_conv.quantized_conv): it then times that checkout's kernels at the
same shapes and leaves out the staged-vs-direct check and the fused op's
checks, which is how the earlier kernels' times beside the new ones are
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
       whose own phase this is; at each of the four shapes the row-shared
       kernel is held bit for bit against its direct (per-pixel) form
       (launch_banded_direct, launch_full_direct), and both are timed in
       one profiler window;
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
     weights from a seed; the worker's aot_compile captures its forward in
     a CUDA graph), 64 single-crop requests in 8 batches, each
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
     1080x1920 JPEG frames, decoded by the native C++ pool (built first
     with g++; a host without the libjpeg/libpng headers prints the
     compiler's error and the phases decode with PIL): two epochs of 4
     train steps (split warp, fused BN) and a test epoch of 2 batches (the
     stem kernel in the eval forward), checkpoints, then -val_only, whose
     SPEC line must equal the trained run's; the decoder and its decode
     ms; a profiled test batch and a profiled train step (no stem kernel
     in it);
 10. depth entry phase, the depth entry point's main path:
     pose_tpu_torch.depth_main with ntu_train.sh's flags (-pretrain from
     the seeded ResNet-50) and POSE_TPU_BN=pallas on a seeded NTU-style
     store of Kinect v2 frames (1080x1920 JPEG colour, 424x512 16-bit PNG
     depth over a 0.5-4.5 m scene; 256 train, 128 valid): (a) -do_fusion,
     a fusion teacher for 1 epoch; (b) -do_teach -do_fusion -attention
     from (a)'s model_1.pth into a depth student for 2 epochs; (c)
     -val_only, whose SPEC line must equal (b)'s last; each epoch 4 train
     steps (split warp at C=3 and C=1, fused BN, the teacher's two stems)
     and a test epoch of 2 batches (the stem kernel); the decoder of every
     loader, one batch's JPEG and PNG decode ms through the pools and
     through PIL (byte-equal), the step and test-batch ms and the wall;
 11. augment phase, the training augmentations' main paths: (a)
     RgbTrainer.train on the train phase's first epoch with -colour
     -eraser (the gated split warp, then the planar colour chain, the
     erase and the normalisation), its step median beside the train
     phase's and, in turns on the same batches, without and with the
     chain; the chain's device ms and launches in a profiled step; (b)
     each colour stream on 8 crops on the card against the CPU with the
     same AugmentDraws and the card's bf16 dot operands (the split
     stream against the CPU's chain on the kernel's own crops): split +
     colour + erase, occluded (mxu warp, paste, colour, erase), general
     (the distorted lookup, paste, colour, erase); then each stage's ms
     at batch 64; (c) pose_tpu_torch.main with cmu_train.sh's flags plus
     -colour -eraser -occluder -occ_path on a seeded store of distorted
     1080x1920 frames (128 train, 64 valid): 1 epoch of 2 steps and a
     1-batch test epoch, every batch through the general lookup, then
     -val_only, whose SPEC line must equal the trained run's.
 12. predict phase, the inference path's main paths, on the entry phases'
     checkpoints and stores: (a) each Predictor variant (rgb, depth,
     fusion, partial_depth, partial_fusion) at full width, bf16 on the card
     against f32 on the CPU with the same weights, on the head features;
     (b) the quantized rgb Predictor (calibrated on 2 batches): the int8
     kernels' own phase (nvcc -Xptxas -v's registers and spills first):
     at every distinct conv shape of the quantized forward at batch 8,
     the heads included, the exact form (int8_conv) bit-equal to its
     plain version (exact f64 sums), quantized_conv bit-equal to
     quantized_conv_plain for bf16 and f32 inputs, int32 and bf16
     accumulators, with and without bias, and the quantize pass on each
     input; both at +-127 and at B=1; the five costliest shapes timed:
     the exact form beside the bound, cuDNN's bf16 conv and
     torch._int_mm on an unfold, the QuantizedConv as a call, the fused
     op's two kernels beside the fused bound and the plain passes around
     the exact form, the quantize pass beside its bound; then 2 served
     batches (conv and quantize launches, no exact-form and no stem
     launch, ms beside bf16 and beside PR 9's route of plain passes, the
     profiled batch's kernels on both) and the card against the CPU's
     quantized forward; (c)
     pose_tpu_torch.predict in-process: the entry's best.pth with
     cmu_train.sh's model flags on 16 HD frames, two people each, with a
     -camera JSON, then with -quantize -calib_batches 2 -track_ids; the
     distilled student (-depth_net) on colour; the fusion teacher on
     colour and depth; a seeded -depth_only -partial_conv model; each run's
     first two samples again in f32 on the card and the CPU.
 13. resume phase (after the entry phases, on their stores and -pretrain
     file; `--only resume` writes its own): the flagship step (ResNet-50,
     bn_impl=pallas, batch 64) run twice from one saved state, with
     cuDNN's deterministic algorithms off (the default) and on, whose
     states must repeat bit for bit, and its ms; (a) the RGB CLI with
     cmu_train.sh's flags and -save_state: an uninterrupted 2-epoch run,
     and a run with -save_every 1 in a child process killed with SIGKILL
     in epoch 2 (the joint+track step) once a snapshot of epoch 2 lands,
     then -resume from its model_1.pth: model_2.pth, train_record.pth and
     full_state/epoch_2.pt equal the uninterrupted run's bit for bit; ms
     a step without and with -save_every 1, and ms a snapshot (the host
     copy, the write); (c) the uninterrupted run's -trace_dir trace of
     epoch 1: its split_warp and fused-BN kernel events equal those
     kernels' launch counters; (b) DepthTrainer.distill_train at the
     depth entry's configuration with -semi_teach, preempted after 2
     steps and resumed: student state, teacher buffers, the semi
     position and the record equal an uninterrupted epoch's bit for bit.
     In the predict phase, (d): the host µs a QuantizedConv call takes to
     enqueue, two threads serving one quantized Predictor (20 batches
     each) equal to the serial answers with 53 + 53 launches a batch, and
     two threads calling one QuantizedConv back to back (300 calls each)
     equal to the serial answers (`--only threads` runs (d) alone, also
     from an earlier checkout).
 14. export phase (last; `--only export` runs it alone), the deployment
     slice's main path: the full-width bf16 and int8 rgb Predictors (batch
     8, the int8 one calibrated on 2 batches) each exported to a .pt2
     (torch.export, the stem and int8 kernels as torch.library ops),
     captured in a CUDA graph by aot_compile, and loaded by
     ArtifactPredictor, eagerly and captured: every form answers 2
     batches bit for bit as the eager Predictor; the profiler's kernels
     of one replay are 1 stem kernel (bf16) or 53 int8 conv and 53
     quantize kernels (int8), since the Python launch counters do not
     move on a replay; a process that imports only torch and
     pose_tpu_torch.ops.library loads both artifacts and answers with the
     same bits; ms a served batch through BatchingServer, the eager
     forward against the graph, bf16 and int8, in turns (host clock); the
     predict CLI on the bf16 .pt2 against its checkpoint, records equal.
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
# the depth entry point's NTU-style store: Kinect v2 frames (1080x1920
# colour, 424x512 16-bit depth over a scene at 0.5-4.5 m), 4 train steps
# and 2 test batches of 64 per epoch
KINECT_DEPTH, KINECT_RANGE_M = (424, 512), (0.5, 4.5)


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
    # the server's aot_compile: the warm-up forwards and the capture; the
    # replays (8 served batches, 8 predict_crops and predict_absolute's)
    # launch the kernel from the graph, without a wrapper call, and
    # serve_breakdown's profile of a replay shows it
    print(f'serve: stem kernel launches {launches["stem_conv"]}', flush=True)
    check(launches['stem_conv'] == serve.CAPTURE_WARMUP + 1,
          'the stem kernel was not launched on the serving path as the '
          f'capture does: {launches["stem_conv"]}')
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
    placed = predictor._place_inputs((pre(frames[:B], homs[:B],
                                          ext[:B]),))[0]
    want = {'stem_conv_kernel': 1, 'int8_conv_kernel': 0,
            'int8_quantize_kernel': 0}
    counts, events, sessions = replay_kernels(
        lambda: predictor._run(placed), want)
    print(f'breakdown: a replay of the served forward under the profiler: '
          f'{events} device events, {counts} ({sessions} session(s))',
          flush=True)
    check(counts == want, f'the served forward\'s replay ran {counts}')


def device_ms(launches, iters, flush=None, each=False):
    """Median device time in ms of one call of each launcher, from the
    profiler's CUDA records over `iters` rounds under one profiler
    (the kernels' own time, without the host time of their wrappers).
    `launches` maps a name to (launch, match, per_call): launch() makes
    `per_call` distinct kernels whose names contain `match`; its time is
    the sum of their medians (with `each`, {kernel name: median} in its
    place). With `flush`, the L2 is overwritten before every call."""
    for fn, _, _ in launches.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the profiler's CUDA records now and then miss launches (49, once 29,
    # of 50 seen on the card; once 10 of 3 x 20 of a kernel that follows
    # another in one call): the rounds are run again under a new profiler,
    # 5 times at most, until each kernel has records of 0.8 * iters calls;
    # each kernel's median over the records kept, summed over the call's
    # kernels
    records = {name: {} for name in launches}
    for attempt in range(1, 6):
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
            if each:
                return {name: {k: float(np.median(v))
                               for k, v in by_kernel.items()}
                        for name, by_kernel in records.items()}
            return {name: float(sum(np.median(v) for v in by_kernel.values()))
                    for name, by_kernel in records.items()}
    raise RuntimeError(f'chip_smoke: the profiler kept {counts} records of '
                       f'{attempt} x {iters} calls')


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


# the kernels of a serving replay as the profiler names them
REPLAY_KERNELS = ('stem_conv_kernel', 'int8_conv_kernel',
                  'int8_quantize_kernel')


def replay_kernels(fn, want):
    """The kernels of fn() (one forward, a graph's replay) under
    torch.profiler, recorded in the session's second step after a first
    step of fn() that warms the profiler up: late in a process that has
    run many profiler sessions, a session's first few dozen device
    records can go missing (a bf16 replay's first 35 events on the card,
    the stem kernel among them). Up to 3 sessions until the counts of
    REPLAY_KERNELS are `want`. Returns (those counts, the device events
    recorded, sessions). (The durations of this second step's records ran
    2-2.5x those of a one-step session on the card, so no time is taken
    from them.)"""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, 4):
        steps = []
        with torch.profiler.profile(
                activities=acts, on_trace_ready=lambda p: steps.append(
                    [e for e in p.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]),
                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                 active=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        cuda = steps[-1]
        counts = {name: sum(name in e.name for e in cuda)
                  for name in REPLAY_KERNELS}
        if counts == want:
            break
    return counts, len(cuda), attempt


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


def banded_case(label, kernel, wrapped, launch, direct, plain, tol, work,
                flush, plain_iters):
    """One shape of the banded or oracle kernel: the wrapper's output (a
    counted launch of the row-shared kernel) against the direct (per-pixel)
    form's on the same inputs, bit for bit, and both against the plain
    version within tol; then both forms timed in one profiler window
    (bare launches into their outputs, L2 flushed), the plain version
    between CUDA events and the bound on this data (`work`: bytes, flops).
    Returns the numbers and the wrapper's output."""
    out = wrapped()
    same = torch.empty_like(out)
    direct(same)
    ref = plain()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    err_d = float((same - ref).abs().max())
    equal = torch.equal(out, same)
    check(bool(torch.isfinite(out).all()), f'{label}: non-finite output')
    check(equal, f'{label}: the row-shared and direct kernels differ')
    check(max(err, err_d) <= tol, f'{label} disagrees with its plain '
          f'version: {max(err, err_d)} > {tol}')
    del ref
    times = device_ms({
        'row_shared': (lambda: launch(out), kernel, 1),
        'direct': (lambda: direct(same),
                   kernel.replace('_kernel', '_direct_kernel'), 1)},
        30, flush)
    plain_ms = time_ms(plain, plain_iters, flush)
    bound, by = bound_of(*work)
    t = dict(ms=times['row_shared'], direct_ms=times['direct'],
             plain_ms=plain_ms, bound_ms=bound, bound_by=by, err=err)
    print(f'{label}: max_abs_err {err:.3g} (direct {err_d:.3g}; tol '
          f'{tol:.3g}); row-shared == direct bit for bit: {equal}; kernel '
          f'{t["ms"]:.5f} ms, direct form {t["direct_ms"]:.5f} ms (L2 '
          f'flushed, one profiler window); plain {plain_ms:.4f} ms; bound '
          f'{bound:.5f} ms by {by} ({work[0]} B, {work[1]} flop); '
          f'{100 * bound / t["ms"]:.1f} % of the bound (direct '
          f'{100 * bound / t["direct_ms"]:.1f} %)', flush=True)
    return t, out


def banded_warp_phase(dev):
    """Kernel phases of the banded kernel and the full-scanline oracle, each
    row-shared kernel beside its direct (per-pixel) form (banded_case): the
    banded kernel at stage B of the split warp, (64, C, 256, 256) f32 ->
    257^2 for the depth stream (C = 1) and colour (C = 3), and both kernels
    on whole 512^2 colour canvases whose crops band_ok_v2 admits (f32 NHWC
    through the banded kernel, uint8 through the oracle), where the banded
    kernel is also held against the oracle kernel."""
    from pose_tpu_torch.ops import warp, warp_banded, warp_cuda

    rng = np.random.RandomState(SEED + 7)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    m = warp.split_defaults((SIDE, SIDE))[0]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    full_m = torch.full((DEPTH_B, 2), m, dtype=torch.int32, device=dev)
    shapes = {}
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
        scal = warp_banded.pack_scalars(residual, full_m)
        work = two_pass_work(residual, (m, m), (SIDE, SIDE), full_m, n_ch, 4,
                             11)[:2]
        label = f'stage B {DEPTH_B}x{n_ch}x{m}^2 f32'
        shapes[label], _ = banded_case(
            f'banded_warp {label} -> {SIDE}^2', 'banded_warp_kernel',
            lambda: warp_banded.banded_warp(inter, residual, full_m,
                                            (SIDE, SIDE), planar_in=True),
            lambda o: warp_banded.launch_banded(inter, scal, o, True),
            lambda o: warp_banded.launch_banded_direct(inter, scal, o, True),
            lambda: warp_banded.banded_warp_plain(
                inter, residual, full_m, (SIDE, SIDE), planar_in=True),
            KERNEL_TOL * max(float(inter.abs().max()), 1.0), work, flush, 5)
        del inter, canvases

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
    print(f'whole {CANVAS}^2 canvases: {DEPTH_B} admitted crops of {drawn} '
          'drawn', flush=True)
    scal = warp_banded.pack_scalars(homs_t, ext)
    n_bytes, n_flops, read = two_pass_work(homs_t, (CANVAS, CANVAS),
                                           (SIDE, SIDE), ext, 3, 1, 11)
    label = f'canvas {DEPTH_B}x{CANVAS}^2x3 f32 NHWC'
    shapes[label], banded = banded_case(
        f'banded_warp {label} -> {SIDE}^2', 'banded_warp_kernel',
        lambda: warp_banded.banded_warp(f32, homs_t, ext, (SIDE, SIDE)),
        lambda o: warp_banded.launch_banded(f32, scal, o, False),
        lambda o: warp_banded.launch_banded_direct(f32, scal, o, False),
        lambda: warp_banded.banded_warp_plain(f32, homs_t, ext,
                                              (SIDE, SIDE)),
        KERNEL_TOL, (n_bytes + int(read.sum()) * 3 * 3, n_flops), flush, 3)
    label = f'oracle {DEPTH_B}x{CANVAS}^2x3 u8'
    oracle, _ = banded_case(
        f'full_warp {label} -> {SIDE}^2', 'full_warp_kernel',
        lambda: warp_banded.full_warp(u8, homs_t, ext, (SIDE, SIDE)),
        lambda o: warp_banded.launch_full(u8, scal, o),
        lambda o: warp_banded.launch_full_direct(u8, scal, o),
        lambda: warp_banded.full_warp_plain(u8, homs_t, ext, (SIDE, SIDE)),
        255 * KERNEL_TOL, (n_bytes, n_flops), flush, 3)
    same = torch.equal(banded, warp_banded.full_warp(f32, homs_t, ext,
                                                     (SIDE, SIDE)))
    print(f'banded == oracle on the admitted f32 canvases: {same}',
          flush=True)
    check(same, 'banded and oracle kernels differ on an admitted batch')
    keys = ('ms', 'direct_ms', 'plain_ms', 'bound_ms', 'bound_by')
    d = shapes[f'stage B {DEPTH_B}x1x{m}^2 f32']
    return {'banded_warp': dict(
        name='banded_warp', route='cuda',
        source='pose_tpu_torch/csrc/banded_warp.cu',
        replaces=REPLACES['banded_warp'],
        max_abs_err=max(t['err'] for t in shapes.values()), ms=d['ms'],
        plain_ms=d['plain_ms'], bound_ms=d['bound_ms'], bound_by=d['bound_by'], library_ms=None,
        shapes={k: {f: t[f] for f in keys} for k, t in shapes.items()}),
        'full_warp': dict(
        name='full_warp', route='cuda',
        source='pose_tpu_torch/csrc/banded_warp.cu',
        replaces=REPLACES['full_warp'], max_abs_err=oracle['err'],
        ms=oracle['ms'], plain_ms=oracle['plain_ms'],
        bound_ms=oracle['bound_ms'], bound_by=oracle['bound_by'],
        library_ms=None, launches=warp_banded.full_warp.launches - full0,
        shapes={label: {f: oracle[f] for f in keys}})}


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

    def __init__(self, rng, n_batches, pre, args, items=None):
        self.pre, self.args = pre, args
        self.items = list(items or [])
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
    """The training main path at full width. Returns the launch counts,
    the first epoch's batch items (the augment phase trains on them) and
    the step median."""
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
    return launches, epochs[0].items, rest


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


def cli_flags(meta, save, model_path, epochs=2):
    """cmu_train.sh's flags on the fixture store, 2 epochs by default; the
    decode pool as wide as the host."""
    return ['-extra_channel', '-half_acc', '-shuffle', '-save_record',
            '-pretrain', '-static_filter', '-joint_space', '-do_track',
            '-model', 'resnet50', '-model_path', model_path, '-suffix',
            'smoke', '-data_name', 'cmu', '-save_path', save, '-criterion',
            'SmoothL1', '-batch_size', str(TRAIN_B), '-learn_rate', '2e-5',
            '-n_cudas', '1', '-n_epochs', str(epochs), '-metadata_path',
            meta, '-workers', str(os.cpu_count() or 1)]


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
    print(f'entry: decoder train {train_l.decoder}, test {test_l.decoder}'
          f'{decoder_why(train_l.decoder_reason)}; host decode median '
          f'{np.median(decode):.1f} ms per batch of {TRAIN_B}', flush=True)
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


def decoder_why(reason):
    """' (why the pool was not taken)' for a decoder line, or ''."""
    return '' if reason is None else f' (native pool unavailable: {reason})'


def native_pool_line():
    """Build the native decode pool (host code, g++ with libjpeg/libpng)
    and say whether it built; a host that cannot build it runs the entry
    phases on PIL. Returns whether it built."""
    from pose_tpu_torch.data import native_loader

    t0 = time.perf_counter()
    try:
        native_loader.get_lib()
    except native_loader.PoolUnavailable as e:
        print(f'decode pool: not built, the loaders decode with PIL: {e}',
              flush=True)
        return False
    print(f'decode pool: {native_loader.LIB_PATH} ready in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    return True


def decode_timing(tl, pooled):
    """One train batch of the depth store decoded through the pools and
    through PIL (the loader's own _decode_images, on this thread): ms per
    batch of each stream and decoder; the two decoders' canvases must be
    byte-equal."""
    idxs = np.arange(TRAIN_B)
    _, paths, dpaths = tl.parse_batch(idxs)
    out = {}
    for stream, files, canvas, pool, gray in (
            ('JPEG', paths, tl.canvas, tl._native, False),
            ('PNG', dpaths, tl.depth_canvas, tl._dnative, True)):
        pools = ((('pool', pool),) if pooled else ()) + (('PIL', None),)
        got = {}
        for name, p in pools:
            t0 = time.perf_counter()
            got[name] = tl._decode_images(files, canvas, p, grayscale=gray)
            out[f'{stream} {name}'] = (time.perf_counter() - t0) * 1e3
        if pooled:
            for a, b in zip(got['pool'], got['PIL']):
                check(np.array_equal(a, b), f'{stream}: the pool and PIL '
                      'decode differently')
    return out


def depth_flags(meta, save, model_path, suffix, epochs):
    """ntu_train.sh's flags on the fixture store; the decode pools as wide
    as the host."""
    return ['-shuffle', '-half_acc', '-pretrain', '-model', 'resnet50',
            '-model_path', model_path, '-suffix', suffix, '-data_name',
            'ntu', '-save_path', save, '-criterion', 'SmoothL1',
            '-num_joints', '17', '-depth_range', '1e3', '-loss_div', '1e1',
            '-n_cudas', '1', '-batch_size', str(TRAIN_B), '-n_epochs',
            str(epochs), '-metadata_path', meta, '-workers',
            str(os.cpu_count() or 1)]


def loader_ms(loaders):
    """Device ms per batch (warp + step) and host decode ms of every
    iteration of the given loaders."""
    steps = [t for ld in loaders for i in range(len(ld.log))
             for t in ld.step_ms(i)]
    decode = [t for ld in loaders for e in ld.log for t in e['decode_ms']]
    return steps, decode


def depth_entry_phase(dev, tmp, pooled):
    """The depth entry point's main path: pose_tpu_torch.depth_main with
    ntu_train.sh's flags and POSE_TPU_BN=pallas on a seeded NTU-style store
    of Kinect v2 frames, -pretrain from a seeded torchvision-key ResNet-50:
    (a) -do_fusion, a fusion teacher for 1 epoch; (b) -do_teach -do_fusion
    -attention from (a)'s model_1.pth into a depth student for 2 epochs;
    (c) -val_only on (b), whose SPEC line must be (b)'s last. Each epoch
    is 4 train steps and a test epoch of 2 batches. Returns the launch
    counts of the three runs."""
    from pose_tpu_torch import depth_main
    from pose_tpu_torch.data import synthetic

    t_phase = time.perf_counter()
    meta = synthetic.make_ntu_fixture(
        os.path.join(tmp, 'ntu'), ENTRY_TRAIN, ENTRY_VALID, seed=SEED,
        imshape=ENTRY_HD, depth_imshape=KINECT_DEPTH,
        workers=os.cpu_count() or 1, depth_scene=KINECT_RANGE_M)
    model_path = os.path.join(tmp, 'resnet50.pth')
    torchvision_state(model_path)
    save = os.path.join(tmp, 'save')
    print(f'depth entry: store of {ENTRY_TRAIN} train and {2 * ENTRY_VALID}'
          f' valid/test samples ({ENTRY_HD[0]}x{ENTRY_HD[1]} JPEG colour, '
          f'{KINECT_DEPTH[0]}x{KINECT_DEPTH[1]} 16-bit PNG depth over a '
          f'{KINECT_RANGE_M[0]}-{KINECT_RANGE_M[1]} m scene) and the '
          f'-pretrain state written in {time.perf_counter() - t_phase:.1f} s',
          flush=True)

    teacher = depth_flags(meta, save, model_path, 'teacher', 1) + [
        '-do_fusion', '-save_record']
    student = depth_flags(meta, save, model_path, 'student', 2) + [
        '-do_fusion', '-do_teach', '-attention', '-teacher_path',
        os.path.join(save, 'resnet50-teacher', 'model_1.pth')]
    kernels = depth_kernels()
    bn = os.environ.get('POSE_TPU_BN')
    os.environ['POSE_TPU_BN'] = 'pallas'
    try:
        zero_launches(kernels)
        t0 = time.perf_counter()
        with NoTilesOverBudget('depth entry', dev):
            runs = [depth_main.main(teacher),
                    depth_main.main(student + ['-save_record'])]
            runs.append(depth_main.main(student + ['-val_only']))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(kernels)
    finally:
        if bn is None:
            os.environ.pop('POSE_TPU_BN')
        else:
            os.environ['POSE_TPU_BN'] = bn
    teach, distill, val = runs
    decoders = {f'{name} {ld.phase}': (ld.decoder, ld.depth_decoder)
                for name, run in (('a', teach), ('b', distill), ('c', val))
                for ld in (run.train_loader, run.test_loader) if ld}
    print(f'depth entry: decoders (colour, depth) {decoders}'
          f'{decoder_why(distill.test_loader.decoder_reason)}', flush=True)
    timing = decode_timing(distill.train_loader, pooled)
    how = (f'the pools with {os.cpu_count()} threads each' if pooled
           else 'the pool not built on this host')
    print(f'depth entry: decode ms per batch of {TRAIN_B} from one thread '
          f'({how}): ' + ', '.join(f'{k} {v:.1f}' for k, v in timing.items()),
          flush=True)
    for tag, run in (('a', teach), ('b', distill)):
        train_ms, decode = loader_ms([run.train_loader])
        test_ms, tdecode = loader_ms([run.test_loader])
        print(f'depth entry ({tag}): {len(train_ms)} train steps, median '
              f'{np.median(train_ms):.2f} ms (per step '
              f'{", ".join(f"{t:.2f}" for t in train_ms)}); {len(test_ms)} '
              f'test batches, median {np.median(test_ms):.2f} ms (per batch '
              f'{", ".join(f"{t:.2f}" for t in test_ms)}; CUDA events on '
              f'the stream between batches: warps + step); host decode '
              f'median {np.median(decode + tdecode):.1f} ms per batch of '
              f'{TRAIN_B} on one of {os.cpu_count()} worker threads; records '
              f'train {run.train}, test {run.test}', flush=True)
        check(len(train_ms) == len(run.train) * ENTRY_TRAIN // TRAIN_B
              and len(test_ms) == len(run.test) * ENTRY_VALID // TRAIN_B,
              f'({tag}) {len(train_ms)} steps and {len(test_ms)} test '
              'batches')
    trained, again = spec_line(distill.test[-1]), spec_line(val.test[0])
    print(f'depth entry: (b) {trained} | (c) -val_only {again}', flush=True)
    check(trained == again, '-val_only SPEC line differs from the trained '
          'run\'s last epoch')
    for rec in teach.train + teach.test + distill.train + distill.test \
            + val.test:
        check(all(np.isfinite(v) for v in rec.values()),
              f'non-finite record {rec}')
    check(all(rec['dist_train_loss'] > 0 for rec in distill.train),
          f'no distillation loss: {distill.train}')
    for suffix, names in (('teacher', ('model_1.pth', 'train_record.pth')),
                          ('student', ('model_1.pth', 'model_2.pth',
                                       'best.pth', 'train_record.pth'))):
        for name in names:
            check(os.path.exists(os.path.join(save, 'resnet50-' + suffix,
                                              name)), f'{name} not written')
    colour = sum(r.train_loader.impl_counts['split'] for r in runs[:2])
    depth = sum(r.train_loader.depth_impl_counts['split'] for r in runs[:2])
    print(f'depth entry: launches {launches}; gated split batches colour '
          f'{colour}, depth {depth}; banded (stage B of split_pallas2) '
          f'{launches["banded_warp"]}; wall of the three runs {wall:.2f} s, '
          f'of the phase {time.perf_counter() - t_phase:.2f} s', flush=True)
    check(launches['split_warp'] == colour > 0, f'split_warp (C=3) '
          f'launched {launches["split_warp"]} times for {colour} batches')
    check(launches['split_warp_depth'] == depth > 0, f'split_warp (C=1) '
          f'launched {launches["split_warp_depth"]} times for {depth} '
          'batches')
    for k in ('fused_bn_stats', 'fused_bn_apply', 'fused_bn_bwd_sums',
              'fused_bn_dx', 'stem_conv'):
        check(launches[k] > 0, f'{k} not launched on the depth entry path')
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


# the augment phase: 4 -colour -eraser steps of the train phase's first
# epoch; 8 crops through each colour stream on the card and the CPU; the
# CLI on a distorted Panoptic HD store, 2 train steps and 1 test batch
AUG_CROPS, AUG_TRAIN, AUG_VALID, AUG_SPRITES = 8, 128, 64, 8
# a stream on the card against the CPU on the same draws and the card's
# bf16 dot operands: f32 sums in another order move a value across a 1/255
# step of the chain's truncation now and then; a moved value is one uint8
# level over the smallest std (0.224) plus the warps' roundoff, and at most
# 1 of 1,000 values may move (the CPU tests' bound against JAX)
AUG_LEVEL = 1 / 255 / 0.224 + 2e-4
AUG_ROUNDOFF = 2e-4
AUG_MOVED_SHARE = 1e-3


class AugmentingPreprocessor:
    """The train phase's gated split warp with -colour -eraser: each batch's
    AugmentDraws from a CPU generator seeded per batch, uploaded, then
    process_color_batch with the chain (the planar colour chain and the
    erase on the split warp's output)."""

    def __init__(self, side_in, dev):
        self.side_in, self.dev = side_in, dev
        self.split_batches = self.mxu_batches = self.n = 0
        self.chain = True

    def draws(self, b):
        from pose_tpu_torch.data import augment

        gen = torch.Generator().manual_seed(SEED * 1000003 + self.n)
        self.n += 1
        return augment.draw_augment(gen, b).to(self.dev)

    def __call__(self, frames, homs, ext, chain=None):
        from pose_tpu_torch.data import augment
        from pose_tpu_torch.ops import warp

        chain = self.chain if chain is None else chain
        homs = np.asarray(homs, np.float32)
        if warp.split_band_ok(homs, (self.side_in, self.side_in)):
            impl = 'split'
            self.split_batches += 1
        else:
            impl = 'mxu'
            self.mxu_batches += 1
        return augment.process_color_batch(
            *(torch.as_tensor(a).to(self.dev) for a in (frames, homs, ext)),
            self.draws(len(frames)), self.side_in, chain, chain,
            warp_impl=impl)


def chain_tail(crops, draws):
    """What process_color_batch does after the split warp under -colour
    -eraser, on clipped planar (B, 3, S, S) crops: the planar colour
    chain, the erase on NHWC, the normalisation."""
    from pose_tpu_torch.ops import colour, occluder

    c = colour.random_color_batch_planar(crops, draws.colour)
    return colour.normalize_imagenet(occluder.random_erase(
        c.permute(0, 2, 3, 1), draws.erase_rgb, draws.erase_area,
        draws.erase_aspect, draws.erase_pos))


def augment_train(dev, items, train_median):
    """(a) RgbTrainer.train on the flagship configuration with -colour
    -eraser: 4 steps on the train phase's first epoch. Returns the split
    kernel's launches on this path."""
    from pose_tpu_torch.models import build_model, init_weights
    from pose_tpu_torch.ops import fused_bn_cuda, warp_cuda
    from pose_tpu_torch.train import (CMU_KEY_INDEX, default_train_args,
                                      engine, steps)

    args = default_train_args(bn_impl='pallas', batch_size=TRAIN_B)
    pre = AugmentingPreprocessor(args.side_in, dev)
    batches = TrainBatches(None, 0, pre, args, items)
    model = init_weights(build_model(args),
                         torch.Generator().manual_seed(SEED))
    trainer = engine.RgbTrainer(args, model, engine.JointInfo(
        None, None, None, CMU_KEY_INDEX), device=dev)
    kernels = {'split_warp': warp_cuda.split_warp, **fused_bn_cuda.KERNELS}
    for fn in kernels.values():
        fn.launches = 0
    with NoTilesOverBudget('augment train', dev):
        record = trainer.train(1, batches)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        batches.events.append(end)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    step_ms = [a.elapsed_time(b) for a, b in zip(batches.events,
                                                 batches.events[1:])]
    median = float(np.median(step_ms[1:]))
    print(f'augment (a): {len(step_ms)} -colour -eraser steps at batch '
          f'{TRAIN_B} (bn_impl=pallas, half_acc, 257^2, ResNet-50): first '
          f'{step_ms[0]:.2f} ms, median of the other {len(step_ms) - 1} '
          f'{median:.2f} ms (per step {", ".join(f"{t:.2f}" for t in step_ms)}'
          f'); the train phase without them {train_median:.2f} ms, '
          f'difference {median - train_median:+.2f} ms; record {record}; '
          f'launches {launches}; split batches {pre.split_batches}, mxu '
          f'batches {pre.mxu_batches}', flush=True)
    check(all(np.isfinite(v) for v in record.values()),
          f'non-finite augmented train loss: {record}')
    check(launches['split_warp'] == pre.split_batches > 0,
          f'split_warp launched {launches["split_warp"]} times for '
          f'{pre.split_batches} gated augmented batches')
    for k in fused_bn_cuda.KERNELS:
        check(launches[k] == N_BN * len(step_ms), f'{k} launched '
              f'{launches[k]} times on the augmented path')

    # within this call, after the main path: epochs of the same 4 batches
    # without and with the chain in turns (plain, chain, chain, plain)
    medians = []
    for chain in (False, True, True, False):
        pre.chain = chain
        batches.events = []
        trainer.train(1, batches)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        batches.events.append(end)
        torch.cuda.synchronize()
        medians.append(float(np.median(
            [a.elapsed_time(b) for a, b in zip(batches.events[1:],
                                               batches.events[2:])])))
    pre.chain = True
    print(f'augment (a): in turns on the same batches, step medians of the '
          f'last 3 of 4 steps: plain {medians[0]:.2f}, chain '
          f'{medians[1]:.2f}, chain {medians[2]:.2f}, plain '
          f'{medians[3]:.2f} ms', flush=True)

    # the chain's share of one profiled step (launches not counted): the
    # tail of process_color_batch after the split warp, with the chain
    # (planar colour, erase on NHWC, normalise) and without (normalise),
    # on the same warped crops; then the whole step with the chain
    from pose_tpu_torch.ops import colour, warp

    item = items[0]
    d = pre.draws(TRAIN_B)
    frames, homs, ext = (torch.as_tensor(item[k]).to(dev)
                         for k in ('frames', 'homs', 'ext'))
    crops = torch.clamp(warp.warp_batch_split(
        frames, homs, (args.side_in, args.side_in), ext, planar_out=True),
        0.0, 1.0)

    def with_chain():
        return chain_tail(crops, d)

    def without():
        return colour.normalize_imagenet_planar(crops).permute(0, 2, 3, 1)

    with_chain(), without()
    torch.cuda.synchronize()
    host_with, host_without = host_ms(with_chain), host_ms(without)
    _, chain_ms, k_with = profile_step(with_chain)
    _, tail_ms, k_without = profile_step(without)
    n_chain = sum(n for _, n in k_with.values())
    n_tail = sum(n for _, n in k_without.values())
    step = steps.make_joint_train_step(args, CMU_KEY_INDEX, True)
    keys = ('image', 'true_cam', 'true_val', 'true_mat', 'intrinsics')

    def full_step():
        step(trainer.state, trainer._place(batches.batch(item), keys), 1e-5)

    full_step()
    torch.cuda.synchronize()
    wall, busy, _ = profile_step(full_step)
    print(f'augment (a): profiled step (upload + warp + chain + mask + '
          f'train step), device busy {busy:.2f} ms of {wall:.2f} ms wall; '
          f'the colour chain, erase and normalise {chain_ms:.3f} ms of '
          f'device time in {n_chain} kernel launches '
          f'({100 * chain_ms / busy:.1f}% of busy), against '
          f'{tail_ms:.3f} ms in {n_tail} for the normalise alone; host '
          f'clock to a synchronize, median of 3: {host_with[1]:.3f} ms with '
          f'the chain, {host_without[1]:.3f} ms without', flush=True)
    check(n_chain > n_tail and chain_ms > tail_ms,
          'the chain launched nothing')
    return launches['split_warp']


def general_inputs(rng, b, canvas, side_in):
    """Partial homographies, source intrinsics and coefficients of crops
    of distorted HD frames on the loader's canvas: realistic_homs composed
    as K_old @ partial with a pinhole K_old of the canvas, and
    coefficients as the distorted fixture draws them (mild barrel,
    small tangential)."""
    homs = realistic_homs(rng, b, canvas, side_in).astype(np.float64)
    f = 0.8 * canvas
    kmat = np.array([[f, 0, canvas / 2], [0, f, canvas / 2], [0, 0, 1]])
    partials = np.linalg.inv(kmat) @ homs
    dist = np.stack([rng.uniform(-0.25, -0.1, b), rng.uniform(0, 0.05, b),
                     rng.uniform(-1e-3, 1e-3, b),
                     rng.uniform(-1e-3, 1e-3, b), np.zeros(b)], -1)
    return (partials.astype(np.float32),
            np.broadcast_to(kmat, (b, 3, 3)).astype(np.float32),
            dist.astype(np.float32))


class CpuWithCardWeights:
    """The CPU reference of a stream with the card's bf16 dot operands
    (warp._default_wdtype picks f32 on the CPU), so that the card and the
    CPU differ only in f32 summation order."""

    def __enter__(self):
        from pose_tpu_torch.ops import warp
        self.saved = warp._default_wdtype
        warp._default_wdtype = lambda device: torch.bfloat16

    def __exit__(self, *exc):
        from pose_tpu_torch.ops import warp
        warp._default_wdtype = self.saved
        return False


def augment_streams(dev, bank_np):
    """(b) Each colour stream on 8 crops, card against CPU with the same
    AugmentDraws; then each stream's ms per batch of 64 on the card."""
    from pose_tpu_torch.data import augment
    from pose_tpu_torch.ops import colour, occluder, warp

    rng = np.random.RandomState(SEED + 21)
    frames, homs, ext = make_frames(rng, AUG_CROPS, CANVAS, SIDE, True)
    parts, kmat, dist = general_inputs(rng, AUG_CROPS, CANVAS, SIDE)
    draws = augment.draw_augment(torch.Generator().manual_seed(SEED + 22),
                                 AUG_CROPS, AUG_SPRITES)
    cpu = torch.device('cpu')
    banks = {d: tuple(torch.from_numpy(a).to(d) for a in bank_np)
             for d in (cpu, dev)}

    def on(d, *arrays):
        return [torch.as_tensor(a).to(d) for a in arrays]

    def split_tail(d):
        # the CPU's chain on the split kernel's own crops: the kernel
        # against its plain version is the kernel phase's check, and its
        # 1e-5 would move values across the truncation's steps here
        if d.type == 'cuda':
            return augment.process_color_batch(
                *on(d, frames, homs, ext), draws.to(d), SIDE, True, True,
                warp_impl='split')
        crops = warp.warp_batch_split(*on(dev, frames, homs), (SIDE, SIDE),
                                      torch.as_tensor(ext).to(dev),
                                      planar_out=True)
        return chain_tail(torch.clamp(crops, 0.0, 1.0).cpu(), draws)

    streams = {
        'split kernel + colour + erase (CPU: the chain on the kernel\'s '
        'crops)': split_tail,
        'occluded (mxu warp, paste, colour, erase)':
            lambda d: augment.process_color_batch_occluded(
                *on(d, frames, homs, ext), draws.to(d), banks[d], SIDE,
                True, True),
        'general (distorted lookup, paste, colour, erase)':
            lambda d: augment.process_color_batch_general(
                *on(d, frames, parts, kmat, dist, ext), draws.to(d), SIDE,
                True, True, bank=banks[d])}
    for name, fn in streams.items():
        card = fn(dev).cpu()
        with CpuWithCardWeights():
            ref = fn(cpu)
        diff = (card - ref).abs()
        moved = int((diff > AUG_ROUNDOFF).sum())
        print(f'augment (b): {name}, {AUG_CROPS} crops, card vs CPU: max '
              f'|diff| {float(diff.max()):.6g} (bound {AUG_LEVEL:.6g}), '
              f'values moved by a uint8 level {moved} of {diff.numel()} '
              f'(bound {int(AUG_MOVED_SHARE * diff.numel())})', flush=True)
        check(torch.isfinite(card).all(), f'{name}: non-finite values')
        check(float(diff.max()) <= AUG_LEVEL and
              moved <= AUG_MOVED_SHARE * diff.numel(),
              f'{name}: the card and the CPU differ')

    # each plain stage's ms per batch of 64 on the card (CUDA events, L2
    # not flushed; set-up excluded)
    rng = np.random.RandomState(SEED + 23)
    f64, h64, e64 = make_frames(rng, TRAIN_B, CANVAS, SIDE, True)
    p64, k64, d64 = general_inputs(rng, TRAIN_B, CANVAS, SIDE)
    dr64 = augment.draw_augment(torch.Generator().manual_seed(SEED + 24),
                                TRAIN_B, AUG_SPRITES).to(dev)
    cv, hm, ex, pt, km, ds = on(dev, f64, h64, e64, p64, k64, d64)
    crops = torch.rand((TRAIN_B, SIDE, SIDE, 3), device=dev,
                       generator=torch.Generator(dev).manual_seed(SEED))
    planar = crops.permute(0, 3, 1, 2).contiguous()
    times = {
        'occluder paste (paste_batch_mxu, 8 chunks of 8)':
            lambda: occluder.paste_batch_mxu(crops, dr64.occ_index,
                                             dr64.occ_scale,
                                             dr64.occ_centre, banks[dev]),
        'general warp (u8 canvases to normalised crops, no chain)':
            lambda: augment.process_color_batch_general(
                cv, pt, km, ds, ex, None, SIDE, False, False),
        'colour chain on planar crops':
            lambda: colour.random_color_batch_planar(planar, dr64.colour),
        'random erase on NHWC crops':
            lambda: occluder.random_erase(crops, dr64.erase_rgb,
                                          dr64.erase_area,
                                          dr64.erase_aspect,
                                          dr64.erase_pos),
        'split warp + colour + erase + normalise':
            lambda: augment.process_color_batch(cv, hm, ex, dr64, SIDE,
                                                True, True,
                                                warp_impl='split'),
        'split warp + normalise (no chain)':
            lambda: augment.process_color_batch(cv, hm, ex, None, SIDE,
                                                False, False,
                                                warp_impl='split')}
    out = {}
    for name, fn in times.items():
        out[name] = time_ms(fn, 5)
        print(f'augment (b): {name}: {out[name]:.4f} ms per batch of '
              f'{TRAIN_B} (CUDA events, median of 5)', flush=True)
    return out


def augment_entry(dev, tmp, occ):
    """(c) pose_tpu_torch.main with cmu_train.sh's flags plus -colour
    -eraser -occluder -occ_path on a seeded store of distorted Panoptic
    HD cameras: 1 epoch of 2 train steps and a test epoch of 1 batch,
    then -val_only with the same SPEC line. Returns the launch counts."""
    from pose_tpu_torch import main as cli
    from pose_tpu_torch.data import synthetic
    from pose_tpu_torch.ops import fused_bn_cuda, stem, warp_cuda

    t0 = time.perf_counter()
    meta = synthetic.make_cmu_fixture(
        os.path.join(tmp, 'store'), AUG_TRAIN, AUG_VALID, seed=SEED + 7,
        imshape=ENTRY_HD, distorted=True, workers=os.cpu_count() or 1)
    model_path = os.path.join(tmp, 'resnet50.pth')
    torchvision_state(model_path)
    save = os.path.join(tmp, 'save')
    argv = cli_flags(meta, save, model_path, epochs=1) + [
        '-colour', '-eraser', '-occluder', '-occ_path', occ, '-occ_count',
        str(AUG_SPRITES)]
    setup_s = time.perf_counter() - t0
    kernels = {'split_warp': warp_cuda.split_warp, 'stem_conv':
               stem.stem_conv, **fused_bn_cuda.KERNELS}
    bn = os.environ.get('POSE_TPU_BN')
    os.environ['POSE_TPU_BN'] = 'pallas'
    try:
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
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
    train_ms, test_ms = train_l.step_ms(0), test_l.step_ms(0)
    trained, reloaded = spec_line(run.test[0]), spec_line(val.test[0])
    print(f'augment (c): store of {AUG_TRAIN} train and {2 * AUG_VALID} '
          f'valid/test distorted {ENTRY_HD[0]}x{ENTRY_HD[1]} frames and the '
          f'-pretrain state in {setup_s:.1f} s; the CLI with -colour '
          f'-eraser -occluder in {wall:.2f} s: train steps '
          f'{", ".join(f"{t:.2f}" for t in train_ms)} ms, test batch '
          f'{", ".join(f"{t:.2f}" for t in test_ms)} ms; warps train '
          f'{dict(train_l.impl_counts)}, test {dict(test_l.impl_counts)}; '
          f'decoder {train_l.decoder}; launches {launches}; records '
          f'{run.train} {run.test}', flush=True)
    print(f'augment (c): trained {trained} | -val_only {reloaded}',
          flush=True)
    check(trained == reloaded, '-val_only SPEC line differs from the '
          'augmented run\'s')
    for rec in run.train + run.test:
        check(all(np.isfinite(v) for v in rec.values()),
              f'non-finite record {rec}')
    check(dict(train_l.impl_counts) == {'general': AUG_TRAIN // TRAIN_B}
          and dict(test_l.impl_counts) == {'general': AUG_VALID // TRAIN_B},
          'the distorted batches did not all take the general lookup')
    check(train_l._occ_bank is not None, 'the occluder bank was not loaded')
    for k in fused_bn_cuda.KERNELS:
        check(launches[k] == N_BN * len(train_ms), f'{k} launched '
              f'{launches[k]} times on the augmented entry path')
    check(launches['stem_conv'] == len(test_ms) and
          launches['split_warp'] == 0, f'launches {launches}: the stem once '
          'a test batch, no split warp on a distorted store')
    return launches


def augment_phase(dev, items, train_median):
    """The augment phase: (a), (b), (c). Returns the split and stem
    launches of its main paths."""
    from pose_tpu_torch.data import synthetic
    from pose_tpu_torch.ops import occluder

    t_phase = time.perf_counter()
    split = augment_train(dev, items, train_median)
    with tempfile.TemporaryDirectory() as tmp:
        occ = synthetic.make_occluder_bank(os.path.join(tmp, 'occ'),
                                           count=AUG_SPRITES, seed=SEED + 3)
        augment_streams(dev, occluder.load_occluder_bank(occ, AUG_SPRITES))
        entry = augment_entry(dev, tmp, occ)
    print(f'augment: phase {time.perf_counter() - t_phase:.2f} s',
          flush=True)
    return {'split_warp': split, 'stem_conv': entry['stem_conv']}


# --------------------------------------------------------- the predict phase

# H100 SXM dense int8 tensor rate (NVIDIA data sheet): 2 ops a multiply-add
INT8_OP_PER_S = 1979e12
# the predict phase's CLI stores: 16 frames, two people a frame on the
# Panoptic store (32 samples, 4 batches of 8)
CLI_FRAMES = 16
# Decoded joints of random-init weights move far under bf16 rounding: the
# eval forward's activations grow through the residual stages (BN holds
# its init statistics), the head logits reach thousands, the soft-argmax
# is nearly an argmax, and a logit error of a few units moves a joint by
# bins of 62.5 mm. So a bf16 forward is held against the f32 one on the
# head features, relative to their largest magnitude, and decoded joints
# are held where both sides compute in f32 (the CLI's agreement run).
# bf16 on the card against f32 on the CPU: ~50 layers each rounding its
# output to 8 bits; measured 0.0096-0.0107 on the five variants (NVIDIA
# H100 80GB HBM3, 700 W)
BF16_FEAT_TOL = 0.05
# the CLI on the card against the CPU, both f32 with the card's bf16 warp
# operands: f32 sums in another order; mm (relat_cam, absolute_cam after
# the root solve) and px (spec_mat); measured at most 0.074 mm, 0.0031 px
# and 0.048 mm on the same card, the bounds about 5x
CLI_F32_TOL = dict(relat_cam=0.5, spec_mat=0.02, absolute_cam=0.5)
# the quantized Predictor on the card against the CPU's (the plain int8
# conv), both bf16 and every conv int8: exact int32 sums, the same bf16
# passes between them; mm and px; measured 0.0016 mm and 4.6e-5 px, and
# a code that crossed a rounding boundary on one side only would move a
# random-init joint by millimetres
INT8_CPU_TOL = dict(relat_cam=0.05, spec_mat=0.005)


def serving_args(**over):
    """The full-width serving configuration: ResNet-50, 257^2, stride 16,
    16 bins, 19 joints, -half_acc; rgb with -joint_space -extra_channel."""
    from pose_tpu_torch import serve
    return serve.default_args(**dict(dict(extra_channel=True), **over))


def serving_crops(rng, dev, n_batches):
    """n_batches of B seeded crops (B, 257, 257, 4) on the card: frames
    through the gated split warp, and a bbox-mask channel of a jittered
    central box."""
    from pose_tpu_torch import serve
    from pose_tpu_torch.data import augment

    pre = serve.GatedPreprocessor(SIDE, device=dev)
    out = []
    for _ in range(n_batches):
        frames, homs, ext = make_frames(rng, B, CANVAS, SIDE, True)
        lo = rng.uniform(40, 90, (B, 2))
        hi = SIDE - rng.uniform(40, 90, (B, 2))
        quads = np.stack([np.stack([lo[:, 0], lo[:, 1]], -1),
                          np.stack([hi[:, 0], lo[:, 1]], -1),
                          np.stack([hi[:, 0], hi[:, 1]], -1),
                          np.stack([lo[:, 0], hi[:, 1]], -1)], 1)
        mask = augment.bbox_mask_channel(
            torch.as_tensor(quads, dtype=torch.float32).to(dev), SIDE)
        out.append(torch.cat([pre(frames, homs, ext), mask], -1))
    return out


def int8_shapes(predictor, scales, x):
    """Every distinct conv shape of the quantized rgb forward on x with
    every conv int8 (skip=(): the heads too): {label: (x, xq,
    QuantizedConv)} with the float input each one sees and its int8
    codes (the plain quantize)."""
    from pose_tpu_torch import quant

    qmodel = quant.quantize_model(predictor.model, scales, skip=())
    shapes = {}

    def record(mod, args):
        xq = torch.clamp(torch.round(args[0].float() / mod.x_scale), -127,
                         127).to(torch.int8)
        g = mod.geom
        label = (f'{mod.path} {tuple(xq.shape)} -> {g.cout} '
                 f'{g.kernel[0]}x{g.kernel[1]}/{g.stride[0]} '
                 f'd{g.dilation[0]}')
        key = (tuple(xq.shape), g)
        if key not in {(tuple(v[1].shape), v[2].geom)
                       for v in shapes.values()}:
            shapes[label] = (args[0], xq, mod)

    hooks = [m.register_forward_pre_hook(record)
             for m in quant.quantized_convs(qmodel).values()]
    try:
        with torch.inference_mode():
            qmodel(*predictor._model_inputs((x,)))
    finally:
        for h in hooks:
            h.remove()
    return shapes


def int8_work(xq, geom):
    """(bytes, ops, M, K) of the exact form: the int8 input and weight read
    once, the int32 output written once; 2 ops a multiply-add."""
    b = xq.shape[0]
    oh, ow = geom.out_hw(*xq.shape[2:])
    m, k = b * oh * ow, geom.k
    return xq.numel() + k * geom.cout + 4 * m * geom.cout, 2 * m * k * \
        geom.cout, m, k


def int8_fused_work(x, geom, has_bias):
    """(bytes, ops) of one quantized conv (the quantize pass and the conv
    with its epilogue as one function): x in its dtype read once, the int8
    weight read once, the output in x's dtype written once, the 0-d input
    scale, the (Cout,) f32 scales and the bias in x's dtype; 2 ops a
    multiply-add."""
    b = x.shape[0]
    oh, ow = geom.out_hw(*x.shape[2:])
    m, size = b * oh * ow, x.element_size()
    n_bytes = (x.numel() * size + geom.k * geom.cout + m * geom.cout * size
               + 4 + 4 * geom.cout + has_bias * size * geom.cout)
    return n_bytes, 2 * m * geom.k * geom.cout


def int_mm_operands(xq, w_oihw, geom):
    """torch._int_mm's operands for the same conv: the unfolded input
    (M, K8) and the weight (K8, N8) int8, K and N zero-padded to multiples
    of 8 (its requirement); unfolded outside any timing."""
    import torch.nn.functional as F

    cols = F.unfold(xq.to(torch.float16), geom.kernel, geom.dilation,
                    geom.padding, geom.stride)               # (B, K, L)
    a = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(torch.int8)
    k8, n8 = -(-a.shape[1] // 8) * 8, -(-geom.cout // 8) * 8
    a = F.pad(a, (0, k8 - a.shape[1])).contiguous()
    w = torch.zeros((n8, k8), dtype=torch.int8, device=xq.device)
    w[:geom.cout, :geom.k] = w_oihw.reshape(geom.cout, -1)
    return a, w.t()


def passes_route(x, w_packed, geom, x_scale, scale, bias, acc_dtype):
    """The quantized conv as PR 9 ran it: plain quantize and dequant passes
    around the exact int8 conv (the timing's and the profile's "before")."""
    from pose_tpu_torch.ops import int8_conv as i8

    xq = torch.clamp(torch.round(x.float() / x_scale), -127, 127)
    y = i8.int8_conv(xq.to(torch.int8), w_packed, geom)
    if acc_dtype == torch.bfloat16:
        y = y.to(torch.bfloat16)
    y = y.float() * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def same_bits(a, b):
    """a and b equal bit for bit (dtype, shape, every value's bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.contiguous().view(view),
                           b.contiguous().view(view))
    return torch.equal(a, b)


def ptxas_report():
    """nvcc -Xptxas -v on csrc/int8_conv.cu (the build's own output, or a
    build of its own where the library was built before): each kernel's
    registers and spills, printed, and its dynamic shared memory (the
    kernel's ring, barriers, scales and biases by tile width,
    csrc/int8_conv.cu smem_bytes)."""
    import re

    from pose_tpu_torch import cuda_build

    log = cuda_build.ptxas_logs.get('int8_conv')
    if log is None:
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run(
                [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, '-Xptxas',
                 '-v', '-o', os.path.join(tmp, 'int8_conv_v.so'),
                 os.path.join(cuda_build.CSRC, 'int8_conv.cu')],
                capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f'nvcc -Xptxas -v failed:\n{proc.stderr}')
        log = proc.stderr
    name, spills = None, ''
    for line in log.splitlines():
        m = re.search(r'int8_conv_kernelILi(\d+)ELi(\d)ELi(\d)E', line)
        q = re.search(r'int8_quantize_kernelI(f|13__nv_bfloat16)E', line)
        if 'Compiling entry function' in line and (m or q):
            if m:
                bn = int(m.group(1))
                stages = 196608 // (1 if bn > 64 else 2) // (16384 + 128 * bn)
                smem = (1024 + stages * (16384 + 128 * bn + 16) + 16
                        + 8 * bn)
                name = (f'int8_conv_kernel<BN {bn}, '
                        f'{("vec16", "word", "byte")[int(m.group(2))]} A, '
                        f'{("int32", "f32", "bf16")[int(m.group(3))]} out>: '
                        f'{smem} B dynamic shared memory ({stages} stages)')
            else:
                name = (f'int8_quantize_kernel<'
                        f'{"f32" if q.group(1) == "f" else "bf16"}>: no '
                        f'shared memory')
        elif name and 'spill' in line:
            spills = line.strip()
        elif name and 'Used' in line:
            print(f'ptxas: {name}; {line.split(":", 1)[1].strip()}; {spills}',
                  flush=True)
            name, spills = None, ''


def fused_inputs(x, mod, dtype, with_bias, gen):
    """The float input in `dtype` (channels_last, as the forward gives it)
    and a bias: the module's own where it has one, else a seeded (Cout, 1,
    1) one in `dtype`, or None."""
    xin = x.to(dtype).contiguous(memory_format=torch.channels_last)
    bias = None
    if with_bias:
        bias = (mod.bias.to(dtype) if mod.bias is not None else torch.randn(
            (mod.geom.cout, 1, 1), generator=gen, device=x.device).to(dtype))
    return xin, bias


def check_fused(x, mod, dtype, acc, bias, label, w_packed=None):
    """quantized_conv bit-equal to quantized_conv_plain on the card, with
    the module's geometry and scales and its weight or `w_packed`."""
    from pose_tpu_torch.ops import int8_conv as i8

    w_packed = mod.weight_packed if w_packed is None else w_packed
    args = (w_packed, mod.geom, mod.x_scale, mod.scale, bias, acc)
    got = i8.quantized_conv(x, *args)
    ref = i8.quantized_conv_plain(x, *args)
    torch.cuda.synchronize()
    check(same_bits(got, ref) and got.is_contiguous(
        memory_format=torch.channels_last),
          f'quantized_conv differs from its plain version at {label} '
          f'({dtype}, acc {acc}, bias {bias is not None}): max |diff| '
          f'{float((got.float() - ref.float()).abs().max())}')


def check_quantize(x, mod, label):
    """The quantize pass against the plain quantize on x, in bf16 and f32:
    quantized_conv with a 1x1 identity weight and unit scales writes each
    int8 code as it is (every integer up to 127 is exact in bf16)."""
    from pose_tpu_torch.ops import int8_conv as i8

    c = x.shape[1]
    eye = torch.eye(c, dtype=torch.int8, device=x.device)[:, :, None, None]
    g = i8.Geometry(c, c, (1, 1), (1, 1), (0, 0), (1, 1))
    ones = torch.ones((c, 1, 1), device=x.device)
    for dtype in (torch.bfloat16, torch.float32):
        xin = x.to(dtype).contiguous(memory_format=torch.channels_last)
        got = i8.quantized_conv(xin, i8.pack_weight(eye), g, mod.x_scale,
                                ones, None, torch.int32)
        ref = torch.clamp(torch.round(xin.float() / mod.x_scale), -127, 127)
        torch.cuda.synchronize()
        check(torch.equal(got.float(), ref), f'int8 quantize pass differs '
              f'from the plain quantize on the {dtype} input of {label}')


def int8_phase(dev, predictor, scales, x):
    """The int8 kernels at every distinct conv shape of the quantized rgb
    forward at batch 8 (the heads too): the exact form equal to its plain
    version (exact f64 sums) bit for bit, and quantized_conv equal to
    quantized_conv_plain bit for bit for bf16 and f32 inputs, int32 and
    bf16 accumulators, with and without a bias, and the quantize pass on
    each input; the adversarial cases; the five costliest shapes by
    multiply-adds timed: the exact form beside the bound, the plain
    version, cuDNN's bf16 F.conv2d and torch._int_mm on an unfold; the
    QuantizedConv as the checkout runs it, the fused op's kernels beside
    the fused bound and the plain passes around the exact form; the
    quantize pass beside its bound. Returns the kernel rows (their
    launches are set by the main paths). From an earlier checkout (no
    quantized_conv) only the exact form and the QuantizedConv as it runs
    there."""
    import torch.nn.functional as F

    from pose_tpu_torch.ops import int8_conv as i8

    fused = hasattr(i8, 'quantized_conv')
    if fused:
        ptxas_report()
    shapes = int8_shapes(predictor, scales, x)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    n_fused = 0
    for label, (xf, xq, mod) in shapes.items():
        got = i8.int8_conv(xq, mod.weight_packed, mod.geom)
        ref = i8.int8_conv_plain(xq, i8.unpack_weight(mod.weight_packed,
                                                      mod.geom), mod.geom)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f'int8_conv differs from its plain '
              f'version at {label}: max |diff| '
              f'{int((got.long() - ref.long()).abs().max())}')
        if not fused:
            continue
        check_quantize(xf, mod, label)
        for dtype in (torch.bfloat16, torch.float32):
            for acc in (torch.int32, torch.bfloat16):
                for with_bias in (False, True):
                    xin, bias = fused_inputs(xf, mod, dtype, with_bias, gen)
                    check_fused(xin, mod, dtype, acc, bias, label)
                    n_fused += 1
    # adversarial: every code at +-127 at the largest K (the sums' largest
    # magnitude, 127^2 K), and B = 1 at the stem and at a vector-path shape
    by_k = sorted(shapes.values(), key=lambda v: v[2].geom.k)
    xf, xq, mod = by_k[-1]
    g = mod.geom
    w = torch.full((g.cout, g.cin) + g.kernel, -127, dtype=torch.int8,
                   device=dev)
    hot = torch.full_like(xq, 127)
    got = i8.int8_conv(hot, i8.pack_weight(w), g)
    ref = i8.int8_conv_plain(hot, w, g)
    torch.cuda.synchronize()
    check(torch.equal(got, ref) and int(got.min()) == -127 * 127 * g.k,
          f'int8_conv at +-127, K {g.k}: min {int(got.min())}')
    if fused:
        # every input code at 127 (x far above the calibrated range), B = 1
        big = torch.full_like(xf, 1e4)[:1]
        for dtype in (torch.bfloat16, torch.float32):
            for acc in (torch.int32, torch.bfloat16):
                for with_bias in (False, True):
                    xin, bias = fused_inputs(big, mod, dtype, with_bias, gen)
                    check_fused(xin, mod, dtype, acc, bias,
                                f'+-127, K {g.k}, B=1', i8.pack_weight(w))
                    n_fused += 1
    for xf1, xq1, mod1 in (by_k[0], by_k[len(by_k) // 2]):
        one = xq1[:1]
        check(torch.equal(i8.int8_conv(one, mod1.weight_packed, mod1.geom),
                          i8.int8_conv_plain(one, i8.unpack_weight(
                              mod1.weight_packed, mod1.geom), mod1.geom)),
              f'int8_conv at B=1 differs ({mod1.path})')
        if fused:
            for dtype in (torch.bfloat16, torch.float32):
                xin, bias = fused_inputs(xf1[:1], mod1, dtype, True, gen)
                check_fused(xin, mod1, dtype, torch.int32, bias,
                            f'{mod1.path} B=1')
                n_fused += 1
    print(f'int8_conv: the exact form bit-equal to its plain version (f64 '
          f'sums) at all {len(shapes)} distinct conv shapes of the quantized'
          f' ResNet-50 rgb forward at batch {B} (skip=()), at +-127 with K = '
          f'{g.k} and at B=1; quantized_conv bit-equal to '
          f'quantized_conv_plain in {n_fused} cases (bf16 and f32 x, int32 '
          f'and bf16 accumulators, with and without bias, the same shapes, '
          f'+-127, B=1), the quantize pass on every input'
          if fused else
          f'int8_conv (this checkout has no quantized_conv): bit-equal to '
          f'its plain version at all {len(shapes)} shapes, +-127, B=1',
          flush=True)

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    costliest = sorted(shapes.items(), key=lambda kv: -int8_work(
        kv[1][1], kv[1][2].geom)[1])[:5]
    timed, quantize = {}, {}
    for label, (xf, xq, mod) in costliest:
        g = mod.geom
        n_bytes, n_ops, m, k = int8_work(xq, g)
        oh, ow = g.out_hw(*xq.shape[2:])
        out = torch.empty((xq.shape[0], oh, ow, g.cout), dtype=torch.int32,
                          device=dev)
        w_oihw = i8.unpack_weight(mod.weight_packed, g).contiguous()
        ms = kernel_ms(lambda: i8.launch(xq, mod.weight_packed, out, g),
                       'int8_conv_kernel', 20, flush)
        plain_ms = time_ms(lambda: i8.int8_conv_plain(xq, w_oihw, g), 5,
                           flush)
        xb = xq.to(torch.bfloat16)
        wb = w_oihw.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        cudnn_ms = time_ms(lambda: F.conv2d(xb, wb, None, g.stride,
                                            g.padding, g.dilation), 10,
                           flush)
        a, bmat = int_mm_operands(xq, w_oihw, g)
        try:
            mm = torch._int_mm(a, bmat)
            same = torch.equal(mm[:, :g.cout].reshape(
                xq.shape[0], oh, ow, g.cout), out)
            int_mm_ms = time_ms(lambda: torch._int_mm(a, bmat), 10, flush)
        except RuntimeError as e:      # the yardstick only; say why
            print(f'int8_conv {label}: torch._int_mm refused: {e}',
                  flush=True)
            same, int_mm_ms = None, None
        bound, by = bound_of(n_bytes, n_ops, INT8_OP_PER_S)
        # the QuantizedConv as this checkout runs it, host time included
        # (the serving forward is host-bound), on the forward's own input
        route_ms = time_ms(lambda: mod(xf), 20, flush)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=cudnn_ms, int_mm_ms=int_mm_ms,
                   route_ms=route_ms, macs=n_ops // 2)
        line = (f'int8_conv {label}: M {m} N {g.cout} K {k}; exact form '
                f'{ms:.5f} ms ({n_ops / ms / 1e9:.1f} TOP/s), bound '
                f'{bound:.5f} ms by {by} ({100 * bound / ms:.1f} % of it); '
                f'plain (f64) {plain_ms:.4f} ms; cuDNN bf16 F.conv2d '
                f'{cudnn_ms:.4f} ms; torch._int_mm on the unfold '
                f'{int_mm_ms if int_mm_ms is None else f"{int_mm_ms:.4f}"} ms'
                f' (equal to the kernel: {same}); QuantizedConv '
                f'{route_ms:.4f} ms')
        if fused:
            p = i8.plan(m, g.cout, mod.weight_packed.shape[1],
                        torch.cuda.get_device_properties(
                            dev).multi_processor_count)
            fb, fo = int8_fused_work(xf, g, mod.bias is not None)
            fbound, fby = bound_of(fb, fo, INT8_OP_PER_S)

            def call():
                return i8.quantized_conv(xf, mod.weight_packed, g,
                                         mod.x_scale, mod.scale, mod.bias,
                                         mod.acc_dtype)

            # both kernels of the call from one profiler session
            med = device_ms({'f': (call, 'int8_', 2)}, 20, flush,
                            each=True)['f']
            qms = sum(v for k, v in med.items() if 'int8_quantize' in k)
            fms = sum(med.values())
            passes_ms = time_ms(lambda: passes_route(
                xf, mod.weight_packed, g, mod.x_scale, mod.scale, mod.bias,
                mod.acc_dtype), 20, flush)
            q_bytes = xf.numel() * (xf.element_size() + 1) + 4
            qbound, qby = bound_of(q_bytes, xf.numel())
            q_plain = time_ms(lambda: torch.clamp(torch.round(
                xf.float() / mod.x_scale), -127, 127).to(torch.int8), 20,
                flush)
            row.update(plan=f'BN {p.bn}, split {p.split}', fused_ms=fms,
                       fused_bound_ms=fbound, fused_bound_by=fby,
                       passes_ms=passes_ms, quantize_ms=qms,
                       quantize_bound_ms=qbound, quantize_plain_ms=q_plain)
            quantize[label] = dict(ms=qms, plain_ms=q_plain, bound_ms=qbound,
                                   bound_by=qby)
            line += (f' (one call); plan BN {p.bn} split {p.split}; fused '
                     f'kernels (quantize + conv) {fms:.5f} ms, fused bound '
                     f'{fbound:.5f} ms by {fby} ({100 * fbound / fms:.1f} %); '
                     f'plain passes around the exact form {passes_ms:.4f} ms;'
                     f' quantize pass {qms:.5f} ms, bound {qbound:.5f} ms by '
                     f'{qby} ({100 * qbound / qms:.1f} %), plain {q_plain:.4f}'
                     f' ms')
        print(line, flush=True)
        timed[label] = row
        del out, xb, wb, a, bmat
    top = timed[costliest[0][0]]
    rows = [dict(name='int8_conv', route='cuda',
                 source='pose_tpu_torch/csrc/int8_conv.cu',
                 replaces='pose_tpu/quant.py:226 (XLA int8 conv; no Pallas '
                          'kernel)',
                 max_abs_err=0.0, ms=top['ms'], plain_ms=top['plain_ms'],
                 bound_ms=top['bound_ms'], bound_by=top['bound_by'],
                 library_ms=top['library_ms'], shapes=timed)]
    if fused:
        q = quantize[costliest[0][0]]
        rows.append(dict(name='int8_quantize', route='cuda',
                         source='pose_tpu_torch/csrc/int8_conv.cu',
                         replaces='pose_tpu/quant.py:212 (XLA quantize ops; '
                                  'no Pallas kernel)',
                         max_abs_err=0.0, ms=q['ms'], plain_ms=q['plain_ms'],
                         bound_ms=q['bound_ms'], bound_by=q['bound_by'],
                         library_ms=None, shapes=quantize))
    return rows


def decode_err(a, b):
    return {k: float(np.abs(a[k] - b[k]).max()) for k in a}


def head_features(predictor, x):
    """The 3D head's features (the logits of the volumetric softmax) of one
    forward, f32 on the CPU."""
    model = (predictor._quant_model if predictor._quant_model is not None
             else predictor.model)
    with torch.inference_mode():
        out = model(*predictor._model_inputs(predictor._on_device(x)))
    return (out[0] if isinstance(out, tuple) else out).float().cpu()


def feature_err(got, ref):
    """max |got - ref| relative to max |ref|, and max |ref|."""
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / scale, scale


def variants_phase(dev):
    """Each Predictor variant at full width on the card (bf16, -half_acc)
    against an f32 Predictor on the CPU with the same bf16-rounded weights,
    on the same 8 seeded crops: the head features within the bf16 bound,
    the decoded joints reported; the stem kernel must launch in every
    variant with a non-partial stem."""
    from pose_tpu_torch import serve
    from pose_tpu_torch.ops import stem

    rng = np.random.RandomState(SEED + 20)
    colour = torch.as_tensor(rng.randn(B, SIDE, SIDE, 3).astype(np.float32))
    mask = torch.zeros((B, SIDE, SIDE, 1))
    mask[:, 60:200, 80:180] = 1.0
    depth = rng.uniform(0.0, 1.0, (B, SIDE, SIDE, 1)).astype(np.float32)
    depth[rng.rand(B, SIDE, SIDE, 1) < 0.1] = 0.0       # sensor holes
    depth = torch.as_tensor(depth)
    plain = dict(extra_channel=False, joint_space=False)
    cases = {'rgb': (serving_args(), (torch.cat([colour, mask], -1),)),
             'depth': (serving_args(depth_only=True, **plain), (depth,)),
             'fusion': (serving_args(**plain), (colour, depth)),
             'partial_depth': (serving_args(depth_only=True, **plain),
                               (depth,)),
             'partial_fusion': (serving_args(**plain), (colour, depth))}
    worst = 0.0
    for variant, (args, x) in cases.items():
        card = serve.Predictor(args, variant, batch_size=B, device=dev,
                               seed=SEED)
        cpu = serve.Predictor(serve.default_args(**dict(vars(args),
                                                        half_acc=False)),
                              variant, card.model.state_dict(),
                              batch_size=B, device='cpu')
        stem.stem_conv.launches = 0
        got = card.predict_crops(*x)
        launched = stem.stem_conv.launches
        ref = cpu.predict_crops(*x)
        feat, scale = feature_err(head_features(card, x),
                                  head_features(cpu, x))
        err = decode_err(got, ref)
        print(f'variants: {variant} card (bf16) vs CPU (f32): head features '
              f'{feat:.4g} of their largest |value| {scale:.4g} (bound '
              f'{BF16_FEAT_TOL}); decoded {", ".join(f"{k} {v:.4g}" for k, v in err.items())}'
              f'; stem kernel launches {launched}', flush=True)
        for k, v in got.items():
            check(v.shape == ref[k].shape and np.all(np.isfinite(v)),
                  f'{variant} {k}: {v.shape}, finite {np.isfinite(v).all()}')
        check(feat <= BF16_FEAT_TOL, f'{variant} head features card vs CPU '
              f'{feat} > {BF16_FEAT_TOL}')
        check((launched > 0) == (variant != 'partial_depth'),
              f'{variant}: stem kernel launches {launched}')
        worst = max(worst, feat)
        del card, cpu
    return worst


def quant_setup(dev):
    """The full-width quantized rgb Predictor (-half_acc, batch 8) and 4
    seeded batches of crops; calibrated on the first 2. Returns the
    predictor, the batches, the scales, the bf16 forward's outputs on
    batches 3-4, its head features and ms a batch, and the calibration's
    seconds."""
    from pose_tpu_torch import serve

    rng = np.random.RandomState(SEED + 21)
    predictor = serve.Predictor(serving_args(), 'rgb', batch_size=B,
                                device=dev, seed=SEED)
    batches = serving_crops(rng, dev, 4)
    fp = [predictor.predict_crops(x) for x in batches[2:]]
    fp_feat = head_features(predictor, (batches[2],))
    fp_ms = host_ms(lambda: predictor.predict_crops(batches[2]))
    t0 = time.perf_counter()
    scales = predictor.quantize(batches[:2])
    torch.cuda.synchronize()
    return predictor, batches, scales, fp, fp_feat, fp_ms, \
        time.perf_counter() - t0


def int8_only(dev):
    """`--only int8`: the quantized Predictor's setup and the int8 kernels'
    phase (also from an earlier checkout, to time its kernel)."""
    predictor, batches, scales = quant_setup(dev)[:3]
    return int8_phase(dev, predictor, scales, batches[2])


def quant_phase(dev):
    """The quantized Predictor at full width (rgb, -half_acc, batch 8):
    calibrated on 2 batches, then 2 served batches: conv and quantize
    kernel launches a batch, stem launches (0), ms a batch beside the bf16
    forward's and beside the same forward with the plain passes around the
    exact form (PR 9's route), the profiled batch's kernels on both, the
    decoded delta int8 vs bf16 (random weights), and the card against the
    CPU's quantized forward (the plain int8 chain). Returns the int8
    kernel rows and the launches of this path."""
    from pose_tpu_torch import quant, serve
    from pose_tpu_torch.ops import int8_conv as i8
    from pose_tpu_torch.ops import stem

    predictor, batches, scales, fp, fp_feat, (fp_first, fp_ms), q_s = \
        quant_setup(dev)
    args = predictor.args
    n_q = len(quant.quantized_convs(predictor._quant_model))
    rows = int8_phase(dev, predictor, scales, batches[2])

    fused = i8.quantized_conv
    fused.launches = fused.quantize_launches = 0
    i8.int8_conv.launches = stem.stem_conv.launches = 0
    q = [predictor.predict_crops(x) for x in batches[2:]]
    launches = {'int8_conv': fused.launches,
                'int8_quantize': fused.quantize_launches}
    exact = i8.int8_conv.launches
    stem_launches = stem.stem_conv.launches
    # ms a batch of the three routes in turns (int8, bf16, PR 9's plain
    # passes around the exact form, then back), all after the kernel
    # phase's profiler sessions, so each pays the same host launch path
    qmodel = predictor._quant_model
    op_route = quant.quantized_conv       # the op, the QuantizedConv's call

    def route(name):
        predictor._quant_model = None if name == 'bf16' else qmodel
        quant.quantized_conv = passes_route if name == 'passes' else op_route
        return host_ms(lambda: predictor.predict_crops(batches[2]))[1]

    turns = {'int8': [], 'bf16': [], 'passes': []}
    try:
        for name in ('int8', 'bf16', 'passes', 'passes', 'bf16', 'int8'):
            turns[name].append(route(name))
        route('passes')
        p_wall, p_busy, p_kernels = profile_step(
            lambda: predictor.predict_crops(batches[2]))
        routed = i8.int8_conv.launches
    finally:
        predictor._quant_model = qmodel
        quant.quantized_conv = op_route
    wall, busy, kernels = profile_step(lambda: predictor.predict_crops(
        batches[2]))
    q_ms, b_ms, p_ms = (float(np.mean(turns[k])) for k in turns)

    def fmt(values):
        return ', '.join(f'{v:.2f}' for v in values)
    delta = {k: max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(q, fp))
             for k in q[0]}
    feat = feature_err(head_features(predictor, (batches[2],)),
                       torch.as_tensor(fp_feat))
    n_b = len(q)
    print(f'quant: {len(scales)} calibrated convs, {n_q} int8 (the heads '
          f'skipped) in {q_s:.2f} s; in {n_b} batches conv kernel launches '
          f'{launches["int8_conv"]} ({launches["int8_conv"] // n_b} a batch),'
          f' quantize kernel launches {launches["int8_quantize"]} '
          f'({launches["int8_quantize"] // n_b} a batch), exact-form '
          f'launches {exact}, stem kernel launches {stem_launches}; '
          f'predict_crops at batch {B} (host clock, median of 3, two turns '
          f'each, their mean): int8 {q_ms:.2f} ms ({fmt(turns["int8"])}), '
          f'bf16 {b_ms:.2f} ms ({fmt(turns["bf16"])}), int8 with PR 9\'s '
          f'route (plain passes around the exact form) {p_ms:.2f} ms '
          f'({fmt(turns["passes"])}); '
          f'bf16 before the kernel phase {fp_ms:.2f} ms (first '
          f'{fp_first:.2f}); a profiled int8 batch '
          f'{sum(n for _, n in kernels.values())} kernels, busy {busy:.2f} '
          f'of {wall:.2f} ms, with PR 9\'s route '
          f'{sum(n for _, n in p_kernels.values())} kernels, busy '
          f'{p_busy:.2f} of {p_wall:.2f} ms; int8 vs bf16 (random weights): '
          f'head features {feat[0]:.4g} of their largest |value| '
          f'{feat[1]:.4g}, decoded relat_cam {delta["relat_cam"]:.4g} mm, '
          f'spec_mat {delta["spec_mat"]:.4g} px', flush=True)
    check(launches['int8_conv'] == launches['int8_quantize'] == n_q * n_b
          and exact == 0 and stem_launches == 0,
          f'launches {launches} (want {n_q} x {n_b} each), exact form '
          f'{exact} (want 0), stem {stem_launches} (want 0)')
    check(routed > 0, 'the plain-passes route did not run the exact form')
    for out in q:
        for k, v in out.items():
            check(np.all(np.isfinite(v)), f'quantized {k} not finite')
    int8_threads(dev, predictor, scales, batches[2:])

    # every conv int8 on both (skip=()): the CPU runs no bf16 convolution
    cpu = serve.Predictor(args, 'rgb', predictor.model.state_dict(),
                          batch_size=B, device='cpu')
    cpu.quantize_with_scales(scales, skip=())
    predictor.quantize_with_scales(scales, skip=())
    err = decode_err(predictor.predict_crops(batches[2]),
                     cpu.predict_crops(batches[2].cpu()))
    print(f'quant: card vs CPU quantized forward (skip=(), the CPU on the '
          f'plain int8 chain): relat_cam {err["relat_cam"]:.4g} mm, spec_mat '
          f'{err["spec_mat"]:.4g} px', flush=True)
    for k, tol in INT8_CPU_TOL.items():
        check(err[k] <= tol, f'quantized {k} card vs CPU {err[k]} > {tol}')
    return rows, launches


def cli_stores(tmp_e, tmp_d):
    """The CLI's inputs from the entry phases' stores: 16 Panoptic HD
    frames with two boxes each (the store's person box and the box beside
    it) and the first sample's camera as JSON; 16 NTU colour frames, their
    16-bit depth PNGs and the first sample's depth camera. Returns paths."""
    from pose_tpu_torch.data import samples as sample_lib

    out = os.path.join(tmp_e, 'predict')
    # <stream>_all: every frame; <stream>_first: the frames of the first
    # batch's first two samples (two people a Panoptic frame)
    dirs = {f'{k}_{n}': os.path.join(out, f'{k}_{n}') for k in
            ('cmu', 'ntu', 'ntud') for n in ('all', 'first')}
    for d in dirs.values():
        os.makedirs(d)
    cmu = [s for s in sample_lib.unpickle(tmp_e, 'store', 'samples.pkl')
           if s['sequence'] == 'seq_valid'][:CLI_FRAMES]
    boxes = {}
    for i, s in enumerate(cmu):
        name = f'frame_{i:02d}.jpg'
        for d in ('cmu_all',) + (('cmu_first',) if i < 1 else ()):
            os.symlink(s['image'], os.path.join(dirs[d], name))
        x, y, w, h = (float(v) for v in s['bbox'])
        boxes[name] = [[x, y, w, h],
                       [min(x + w, ENTRY_HD[1] - w - 1), y, w, h]]
    cam = cmu[0]['camera']
    files = {'boxes': os.path.join(out, 'boxes.json'),
             'camera': os.path.join(out, 'camera.json'),
             'depth_camera': os.path.join(out, 'depth_camera.json')}
    with open(files['boxes'], 'w') as f:
        json.dump(boxes, f)
    with open(files['camera'], 'w') as f:
        json.dump(dict(K=np.asarray(cam.intrinsic_matrix).tolist(),
                       R=np.asarray(cam.R).tolist(),
                       optical_center=np.asarray(cam.t).tolist(),
                       world_up=list(np.asarray(cam.world_up, float))), f)
    root = os.path.join(tmp_d, 'ntu')
    ntu = sample_lib.get_samples('ntu', root, 'valid')[:CLI_FRAMES]
    dcams = sample_lib.load_depth_cameras('ntu', root)
    for i, s in enumerate(ntu):
        first = ('_first',) if i < 2 else ()
        for suffix in ('_all',) + first:
            os.symlink(s['image'], os.path.join(dirs['ntu' + suffix],
                                                f'frame_{i:02d}.jpg'))
            os.symlink(sample_lib.depth_image_path('ntu', root, s),
                       os.path.join(dirs['ntud' + suffix],
                                    f'depth_{i:02d}.png'))
    dcam = sample_lib.depth_cam_for('ntu', dcams, ntu[0])
    with open(files['depth_camera'], 'w') as f:
        json.dump(dict(K=np.asarray(dcam.intrinsic_matrix).tolist()), f)
    return dirs, files, out


def predict_cli_phase(dev, tmp_e, tmp_d):
    """python -m pose_tpu_torch.predict in-process on the card: (a) the
    entry phase's best.pth with cmu_train.sh's model flags on 16 HD frames
    with two people each, a -camera JSON, then with -quantize
    -calib_batches 2 -track_ids; (b) the depth entry phase's distilled
    student (-depth_net) on colour frames; (c) its fusion teacher on colour
    and depth; (d) a -depth_only -partial_conv model from seeded weights.
    Each run's records are finite; the first batch's first two samples,
    run again on the card and on the CPU in f32 (the same flags but
    -half_acc; the CPU with the card's bf16 warp operands), agree. Returns
    the stem, int8 conv and quantize kernel launches of the card runs (the
    -half_acc ones)."""
    from pose_tpu_torch import predict, serve
    from pose_tpu_torch.ops import int8_conv as i8
    from pose_tpu_torch.ops import stem

    t_phase = time.perf_counter()
    dirs, files, out = cli_stores(tmp_e, tmp_d)
    partial = os.path.join(out, 'partial_depth.pth')
    seeded = serve.Predictor(serve.default_args(
        joint_space=False, depth_only=True, half_acc=False, num_joints=17),
        'partial_depth', batch_size=1, device='cpu', seed=SEED + 22)
    torch.save({'state': {}, 'model': seeded.model.state_dict()}, partial)
    del seeded
    cmu = ['-model', 'resnet50', '-half_acc', '-batch_size', str(B),
           '-joint_space',
           '-extra_channel', '-num_joints', '19', '-skeleton', 'cmu',
           '-model_path', os.path.join(tmp_e, 'save', 'resnet50-smoke',
                                       'best.pth'),
           '-bboxes', files['boxes'], '-camera', files['camera']]
    # the depth stack's 17 joints are the h36m skeleton (depth_main)
    ntu = ['-model', 'resnet50', '-half_acc', '-batch_size', str(B),
           '-num_joints', '17',
           '-depth_range', '1e3', '-skeleton', 'h36m']
    dsave = os.path.join(tmp_d, 'save')
    depth_in = ['-depth_camera', files['depth_camera']]
    runs = {
        'a rgb': (cmu, 'cmu', None),
        'a rgb -quantize': (cmu + ['-quantize', '-calib_batches', '2',
                                   '-track_ids'], 'cmu', None),
        'b student': (ntu + ['-depth_net', '-model_path', os.path.join(
            dsave, 'resnet50-student', 'model_2.pth')], 'ntu', None),
        'c fusion teacher': (ntu + ['-do_fusion', '-model_path', os.path.join(
            dsave, 'resnet50-teacher', 'model_1.pth')] + depth_in, 'ntu',
            'ntud'),
        'd partial_depth': (ntu + ['-depth_only', '-partial_conv',
                                   '-model_path', partial] + depth_in, None,
                            'ntud'),
    }
    launches = {'stem_conv': 0, 'int8_conv': 0, 'int8_quantize': 0}
    firsts = {}
    for tag, (flags, colour, depth) in runs.items():
        def inputs(which):
            args = []
            if colour:
                args += ['-images', os.path.join(dirs[f'{colour}_{which}'],
                                                 '*.jpg')]
            if depth:
                args += ['-depth_images', os.path.join(
                    dirs[f'{depth}_{which}'], '*.png')]
            return args
        i8.quantized_conv.launches = stem.stem_conv.launches = 0
        i8.quantized_conv.quantize_launches = i8.int8_conv.launches = 0
        t0 = time.perf_counter()
        blob = predict.main(flags + inputs('all') + [
            '-out', os.path.join(out, f'{tag}.json')], device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {'stem_conv': stem.stem_conv.launches,
               'int8_conv': i8.quantized_conv.launches,
               'int8_quantize': i8.quantized_conv.quantize_launches}
        check(i8.int8_conv.launches == 0, f'{tag}: the exact form ran '
              f'{i8.int8_conv.launches} times on the CLI path')
        for k in launches:
            launches[k] += got[k]
        recs = blob['frames']
        n_batches = -(-len(recs) // B)
        for rec in recs:
            for k, v in rec.items():
                if k in ('relat_cam', 'spec_mat', 'absolute_cam',
                         'absolute_world', 'image_coord'):
                    check(np.all(np.isfinite(v)), f'{tag}: {k} not finite')
        first = recs[:B]
        if 'quantize' in tag:
            # batch 1 is inside the calibration window: the float forward
            same = max(float(np.abs(np.asarray(a['relat_cam'])
                                    - np.asarray(b['relat_cam'])).max())
                       for a, b in zip(first, firsts['a rgb']))
            delta = max(float(np.abs(np.asarray(a['relat_cam'])
                                     - np.asarray(b['relat_cam'])).max())
                        for a, b in zip(recs[B:], cli_float[B:]))
            ids = sorted({r['track_id'] for r in recs})
            print(f'predict ({tag}): batch 1 (float, in the window) vs the '
                  f'float run {same:.3g} mm; batches 2-{n_batches} int8 vs '
                  f'float {delta:.4g} mm (random-init heads and trunk of the '
                  f'entry run); track ids {ids}', flush=True)
            check(same <= 0.05, 'the first -quantize batch is not the float '
                  f'forward: {same} mm')
            # the float batch and the two calibration forwards
            check(got['stem_conv'] == 3 and got['int8_conv'] > 0
                  and got['int8_quantize'] == got['int8_conv'],
                  f'{tag}: launches {got}')
        else:
            # the first two samples through the card and the CPU in f32,
            # the CPU with the card's bf16 warp operands
            f32 = [a for a in flags if a != '-half_acc'] + inputs('first') + [
                '-batch_size', '2', '-out']
            card32 = predict.main(f32 + [os.path.join(out, f'{tag} f32.json')],
                                  device=dev)['frames']
            with CpuWithCardWeights():
                cpu = predict.main(f32 + [os.path.join(out, f'{tag} cpu.json')],
                                   device='cpu')['frames']
            err, bf16 = {}, {}
            for a, b, c in zip(card32, cpu, first):
                check(a['key'] == b['key'] == c['key']
                      and a['bbox'] == b['bbox'] == c['bbox'],
                      f'{tag}: record order differs')
                for k in CLI_F32_TOL:
                    if k in a:
                        err[k] = max(err.get(k, 0.0), float(np.abs(
                            np.asarray(a[k]) - np.asarray(b[k])).max()))
                        bf16[k] = max(bf16.get(k, 0.0), float(np.abs(
                            np.asarray(c[k]) - np.asarray(a[k])).max()))
            print(f'predict ({tag}): first two samples, card vs CPU (f32) '
                  f'{", ".join(f"{k} {v:.4g}" for k, v in err.items())}; '
                  f'the -half_acc run against the card\'s f32 '
                  f'{", ".join(f"{k} {v:.4g}" for k, v in bf16.items())} '
                  '(random-init logits)', flush=True)
            for k, v in err.items():
                check(v <= CLI_F32_TOL[k], f'{tag}: {k} card vs CPU {v} > '
                      f'{CLI_F32_TOL[k]}')
            firsts[tag] = first
            if tag == 'a rgb':
                cli_float = recs
            check(got['int8_conv'] == got['int8_quantize'] == 0 and (
                got['stem_conv'] > 0) == (
                'partial' not in tag), f'{tag}: launches {got}')
        print(f'predict ({tag}): {len(recs)} records in {n_batches} batches '
              f'of {B}, variant {blob["variant"]}; main() {wall:.2f} s, '
              f'{1e3 * wall / n_batches:.1f} ms a batch, '
              f'{len(recs) / wall:.1f} samples/s (host clock, the whole '
              f'main(): model build, JPEG/PNG decode, warps, forward, '
              f'decode); launches {got}', flush=True)
        check(len(recs) == (2 if colour == 'cmu' else 1) * CLI_FRAMES,
              f'{tag}: {len(recs)} records')
    print(f'predict: CLI phase {time.perf_counter() - t_phase:.2f} s',
          flush=True)
    return launches


def predict_phase(dev, tmp_e, tmp_d):
    """The predict phase: variants, the quantized Predictor with the int8
    kernels' own phase, the CLI. Returns the int8 conv and quantize rows
    and the stem's launches on the CLI."""
    t0 = time.perf_counter()
    variants_phase(dev)
    rows, quant_launches = quant_phase(dev)
    cli = predict_cli_phase(dev, tmp_e, tmp_d)
    for row in rows:
        name = row['name']
        row['launches_by_path'] = {'quant': quant_launches[name],
                                   'predict': cli[name]}
        row['launches'] = sum(row['launches_by_path'].values())
        check(quant_launches[name] > 0 and cli[name] > 0,
              f'{name} was not launched on the quant and predict paths')
    print(f'predict: phase {time.perf_counter() - t0:.2f} s', flush=True)
    return rows, cli['stem_conv']


# ------------------------------------------------------------ export phase

# the export phase's CLI: seeded 480x640 JPEG frames, one person each
# (full-frame boxes), one batch of B
EXPORT_FRAMES = (B, 480, 640)
# a process that imports torch and the ops library alone loads both
# artifacts and answers the served batches; argv: the .pt2 paths (comma
# separated), the inputs' file, the answers' file
LOAD_ONLY = '''
import sys
import torch
import pose_tpu_torch.ops.library as library
paths, inputs, out = sys.argv[1:4]
batches = torch.load(inputs)
answers = []
for path in paths.split(','):
    fn = library.load_artifact(path)
    with torch.inference_mode():
        answers.append([{k: v.cpu() for k, v in fn(x.cuda()).items()}
                        for x in batches])
torch.save(answers, out)
bad = sorted(m for m in sys.modules if m.startswith((
    'pose_tpu_torch.models', 'pose_tpu_torch.serve', 'pose_tpu_torch.quant',
    'pose_tpu.', 'jax')))
assert not bad, bad
print(len(answers), 'artifacts loaded in a process with',
      len([m for m in sys.modules if m.startswith('pose_tpu_torch')]),
      'modules of pose_tpu_torch')
'''


class EagerServing:
    """A Predictor's surface for BatchingServer with its eager forward (no
    graph; aot_compile is a warm-up): the graph's baseline in the served
    batch's timing."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.batch_size, self.device = predictor.batch_size, predictor.device
        self._warm = False

    def _place_inputs(self, inputs):
        return self.predictor._place_inputs(inputs)

    @torch.inference_mode()
    def _run(self, inputs):
        return self.predictor._forward_impl(*inputs)

    def aot_compile(self):
        """The warm-up, once (BatchingServer's worker calls it before every
        batch)."""
        if not self._warm:
            p = self.predictor
            self._run(p._sample_inputs(self.batch_size))
            torch.cuda.synchronize()
            self._warm = True
        return self._run


def served_ms(predictor, batches):
    """Host-clock ms a served batch through a BatchingServer: B single-crop
    requests submitted, to the B-th answer; (first, median of the rest)."""
    from pose_tpu_torch import serve

    ms = []
    with serve.BatchingServer(predictor, max_delay_ms=50.0) as server:
        for x in batches:
            t0 = time.perf_counter()
            for fut in [server.submit(c) for c in x]:
                fut.result(timeout=300)
            ms.append((time.perf_counter() - t0) * 1e3)
        check(server.batches == len(batches), f'{server.batches} batches '
              f'served for {len(batches)}')
    return ms[0], float(np.median(ms[1:]))


def same_answers(got, want):
    """Whether two lists of answer dicts (numpy or tensors) are equal bit
    for bit."""
    return len(got) == len(want) and all(
        set(g) == set(w) and all(np.array_equal(np.asarray(g[k]),
                                                np.asarray(w[k])) for k in w)
        for g, w in zip(got, want))


def export_cli(dev, tmp, predictor, pt2):
    """pose_tpu_torch.predict on seeded JPEG frames with the flagship's
    model flags, once on a checkpoint of `predictor`'s weights and once on
    its .pt2 (exported at batch B): the records must be equal. Returns the
    two main() walls in s."""
    from PIL import Image

    from pose_tpu_torch import predict

    rng = np.random.RandomState(SEED + 32)
    frames = os.path.join(tmp, 'frames')
    os.makedirs(frames)
    for i in range(EXPORT_FRAMES[0]):
        Image.fromarray(rng.randint(0, 256, EXPORT_FRAMES[1:] + (3,),
                                    dtype=np.uint8)).save(
            os.path.join(frames, f'frame_{i}.jpg'))
    ckpt = os.path.join(tmp, 'model_1.pth')
    torch.save({'state': {}, 'model': predictor.model.state_dict()}, ckpt)
    flags = ['-model', 'resnet50', '-half_acc', '-joint_space',
             '-extra_channel', '-num_joints', '19', '-skeleton', 'cmu',
             '-batch_size', str(B), '-images',
             os.path.join(frames, '*.jpg'), '-track_ids']
    blobs, walls = [], []
    for tag, path in (('checkpoint', ckpt), ('pt2', pt2)):
        t0 = time.perf_counter()
        blobs.append(predict.main(flags + [
            '-model_path', path, '-out', os.path.join(tmp, f'{tag}.json')],
            device=dev))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    recs = [b['frames'] for b in blobs]
    check(len(recs[0]) == EXPORT_FRAMES[0], f'{len(recs[0])} records')
    for rec in recs[1]:
        for k in ('relat_cam', 'spec_mat', 'absolute_cam'):
            check(np.all(np.isfinite(rec[k])), f'CLI on the .pt2: {k} not '
                  'finite')
    check(recs[0] == recs[1], 'the CLI on the .pt2 gives other records than '
          'on the checkpoint')
    return walls


def export_phase(dev):
    """The deployment slice's main path at full width (ResNet-50 rgb,
    -half_acc -extra_channel -joint_space, batch 8): a bf16 and an int8
    Predictor (calibrated on 2 batches of crops from the gated split warp
    and the bbox mask), each exported to a .pt2, captured by aot_compile,
    and its artifact loaded by ArtifactPredictor (eagerly and captured):
    every form answers two batches bit for bit as the eager Predictor; a
    replay's profiled kernels are the stem kernel (bf16) or 53 int8 conv
    and 53 quantize kernels (int8); a process that imports only torch and
    the ops library answers both artifacts with the same bits; ms a served
    batch through BatchingServer, eager against the graph, bf16 and int8,
    in turns (host clock, 8 batches each, median of 7); the predict CLI on
    the bf16 .pt2 against its checkpoint. Returns the wrapper launches of
    the path (eager forwards, warm-ups and captures; a replay makes
    none)."""
    from pose_tpu_torch import quant, serve
    from pose_tpu_torch.ops import int8_conv as i8
    from pose_tpu_torch.ops import stem

    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 31)
    batches = serving_crops(rng, dev, 4)
    predictors = {name: serve.Predictor(serving_args(), 'rgb', batch_size=B,
                                        device=dev, seed=SEED)
                  for name in ('bf16', 'int8')}
    predictors['int8'].quantize(batches[:2])
    n_q = len(quant.quantized_convs(predictors['int8']._quant_model))
    served = batches[2:]
    stem.stem_conv.launches = 0
    i8.quantized_conv.launches = i8.quantized_conv.quantize_launches = 0
    i8.int8_conv.launches = 0
    eager, paths = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, p in predictors.items():
            eager[name] = [p.predict_crops(x) for x in served]
            t0 = time.perf_counter()
            paths[name] = p.export_artifact(os.path.join(tmp, f'{name}.pt2'))
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            p.aot_compile()
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            graph = [p.predict_crops(x) for x in served]
            t0 = time.perf_counter()
            art = serve.ArtifactPredictor(paths[name], device=dev)
            load_s = time.perf_counter() - t0
            check(art.in_shapes == ((B, SIDE, SIDE, 4),)
                  and art.out_shapes == ((B, 19, 3), (B, 19, 2)),
                  f'{name} artifact shapes {art.in_shapes} '
                  f'{art.out_shapes}')
            art_eager = [art.predict_crops(x) for x in served]
            art.aot_compile()
            art_graph = [art.predict_crops(x) for x in served]
            for form, got in (('graph', graph), ('artifact', art_eager),
                              ('artifact graph', art_graph)):
                errs = [decode_err(g, e) for g, e in zip(got, eager[name])]
                check(same_answers(got, eager[name]), f'{name}: the {form} '
                      f'answers differ from the eager Predictor\'s: {errs}')
            placed = p._place_inputs((served[0],))[0]
            want = ({'stem_conv_kernel': 1, 'int8_conv_kernel': 0,
                     'int8_quantize_kernel': 0} if name == 'bf16' else
                    {'stem_conv_kernel': 0, 'int8_conv_kernel': n_q,
                     'int8_quantize_kernel': n_q})
            counts, events, _ = replay_kernels(lambda: p._run(placed), want)
            a_counts, a_events, _ = replay_kernels(
                lambda: art._run(placed), want)
            replay_ms = time_ms(lambda: p._run(placed), 20)
            a_replay_ms = time_ms(lambda: art._run(placed), 20)
            mib = os.path.getsize(paths[name]) / 2**20
            print(f'export ({name}): .pt2 of {mib:.1f} MiB exported in '
                  f'{export_s:.2f} s, loaded in {load_s:.2f} s; '
                  f'aot_compile (warm-up and capture) {capture_s:.2f} s; the '
                  f'graph, the artifact and the artifact\'s graph answer '
                  f'{len(served)} batches bit for bit as the eager '
                  f'Predictor; a replay (copy-in, graph, clone of the '
                  f'outputs): {replay_ms:.3f} ms between CUDA events '
                  f'(median of 20), {events} device events, {counts}; the '
                  f'artifact\'s replay {a_replay_ms:.3f} ms, {a_events} '
                  f'events, {a_counts}', flush=True)
            check(counts == want and a_counts == want, f'{name}: replay '
                  f'kernels {counts}, artifact {a_counts}, want {want}')
        launches = {'stem_conv': stem.stem_conv.launches,
                    'int8_conv': i8.quantized_conv.launches,
                    'int8_quantize': i8.quantized_conv.quantize_launches}
        check(i8.int8_conv.launches == 0, 'the exact int8 form ran on the '
              'export path')

        torch.save([x.cpu() for x in served], os.path.join(tmp, 'x.pt'))
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-c', LOAD_ONLY,
             ','.join(paths[k] for k in predictors),
             os.path.join(tmp, 'x.pt'), os.path.join(tmp, 'answers.pt')],
            env=env, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f'the load-only process failed:\n'
              f'{proc.stderr[-3000:]}')
        loaded = torch.load(os.path.join(tmp, 'answers.pt'))
        for name, got in zip(predictors, loaded):
            check(same_answers([{k: v[:B] for k, v in g.items()} for g in got],
                               eager[name]),
                  f'{name}: the load-only process answers differently')
        print(f'export: {proc.stdout.strip()}, equal bits on both '
              f'({time.perf_counter() - t0:.2f} s, the process included)',
              flush=True)

        requests = batches + batches
        turns = {(name, form): [] for name in predictors
                 for form in ('eager', 'graph')}
        for name, form in (('bf16', 'eager'), ('bf16', 'graph'),
                           ('int8', 'eager'), ('int8', 'graph'),
                           ('int8', 'graph'), ('int8', 'eager'),
                           ('bf16', 'graph'), ('bf16', 'eager')):
            p = predictors[name]
            turns[name, form].append(served_ms(
                p if form == 'graph' else EagerServing(p), requests))
        print(f'export: ms a served batch of {B} through BatchingServer '
              f'(host clock, {len(requests)} batches, first, median of the '
              f'rest; two turns each): ' + '; '.join(
                  f'{name} {form} ' + ', '.join(
                      f'{first:.2f} / {med:.2f}' for first, med in v)
                  for (name, form), v in turns.items()) + f' ({card_line()})',
              flush=True)
        walls = export_cli(dev, tmp, predictors['bf16'], paths['bf16'])
        print(f'export: the predict CLI on the bf16 .pt2 gives the '
              f'checkpoint run\'s records; main() {walls[0]:.2f} s on the '
              f'checkpoint, {walls[1]:.2f} s on the .pt2', flush=True)
    print(f'export: phase {time.perf_counter() - t_phase:.2f} s; wrapper '
          f'launches {launches}', flush=True)
    return launches


def export_only(dev):
    """`--only export`: the export phase."""
    export_phase(dev)
    return []


# ------------------------------------------------------------ resume phase

RESUME_STEPS = 3                   # steps a run of the determinism probe
RESUME_SEMI_B = 16                 # ntu_train.sh's -semi_batch default


class bn_pallas:
    """POSE_TPU_BN=pallas (the fused-BN kernels) inside the block."""

    def __enter__(self):
        self.saved = os.environ.get('POSE_TPU_BN')
        os.environ['POSE_TPU_BN'] = 'pallas'

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop('POSE_TPU_BN')
        else:
            os.environ['POSE_TPU_BN'] = self.saved
        return False


def tree_diff(a, b, where=''):
    """The paths at which two payloads (dicts, lists, tensors, numbers)
    differ; tensors compared bit for bit."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        ok = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
              and same_bits(a, b))
        return [] if ok else [where]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f'{where} keys {sorted(set(a) ^ set(b))}']
        return [d for k in a for d in tree_diff(a[k], b[k], f'{where}/{k}')]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f'{where} length {len(a)} != {len(b)}']
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in tree_diff(x, y, f'{where}[{i}]')]
    return [] if a == b and type(a) is type(b) else [f'{where}: {a} != {b}']


def determinism_probe(dev):
    """The flagship step (ResNet-50, bn_impl=pallas, batch 64) run twice
    from one saved state, RESUME_STEPS steps each, with cuDNN's
    deterministic algorithms off (PyTorch's default) and on: whether the
    two runs' states are equal bit for bit, and ms a step (CUDA events).
    Returns {deterministic: (equal, [ms])}."""
    from pose_tpu_torch import serve
    from pose_tpu_torch.models import build_model, init_weights
    from pose_tpu_torch.train import (CMU_KEY_INDEX, default_train_args,
                                      engine, state_io)

    args = default_train_args(bn_impl='pallas', batch_size=TRAIN_B)
    rng = np.random.RandomState(SEED + 31)
    pre = serve.GatedPreprocessor(args.side_in, device=dev)
    batches = TrainBatches(rng, RESUME_STEPS, pre, args)
    model = init_weights(build_model(args),
                         torch.Generator().manual_seed(SEED))
    info = engine.JointInfo(None, None, None, CMU_KEY_INDEX)
    trainer = engine.RgbTrainer(args, model, info, device=dev)
    step = trainer._get_joint_step(True)
    keys = ('image', 'true_cam', 'true_val', 'true_mat', 'intrinsics')
    saved = state_io.host_train_state(trainer.state)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    out = {}
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            torch.backends.cudnn.benchmark = False
            states, ms = [], []
            for _ in range(2):
                trainer.load_state(saved)
                for it in batches.items:
                    batch = trainer._place(batches.batch(it), keys)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    step(trainer.state, batch, 2e-5)
                    end.record()
                    end.synchronize()
                    ms.append(start.elapsed_time(end))
                states.append(state_io.host_train_state(trainer.state))
            out[det] = (not tree_diff(*states), ms)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    for det, (equal, ms) in out.items():
        print(f'resume: the flagship step from one saved state, twice '
              f'{RESUME_STEPS} steps, cudnn.deterministic={det}: states '
              f'{"equal" if equal else "DIFFERENT"} bit for bit; ms a step '
              f'(CUDA events, the first of each run warm from the run '
              f'before) {", ".join(f"{t:.2f}" for t in ms)}, median '
              f'{np.median(ms):.2f}', flush=True)
    # -save_state leaves cuDNN's defaults (no benchmark, deterministic
    # off): a resume is bit-exact only while they repeat the step's bits
    check(all(equal for equal, _ in out.values()), 'the flagship step '
          'from one saved state does not repeat its bits')
    return out


def snapshot_line(log):
    """ms per snapshot: the host copy (synchronous), the wait for the write
    before, the write (the background thread)."""
    def stat(key):
        values = [e[key] for e in log if key in e]
        return (f'{np.median(values):.1f} (' + ', '.join(
            f'{v:.1f}' for v in values) + ')') if values else 'none'
    return (f'{len(log)} snapshots, host copy ms {stat("copy_ms")}, wait '
            f'for the write before ms {stat("wait_ms")}, write ms '
            f'{stat("write_ms")}')


def trace_kernel_counts(path, names):
    """Kernel events of the Chrome trace at `path` whose names contain
    each of `names`."""
    with open(path) as file:
        events = json.load(file)['traceEvents']
    kernels = [e.get('name', '') for e in events if e.get('cat') == 'kernel']
    annotations = [e.get('name', '') for e in events
                   if e.get('cat') == 'user_annotation']
    return ({n: sum(n in k for k in kernels) for n in names}, len(kernels),
            annotations)


# the kernels of an RGB train step as a trace names them, by wrapper
TRACE_KERNELS = {'split_warp': 'split_warp_kernel',
                 'fused_bn_stats': 'fbn_stats_partial_kernel',
                 'fused_bn_apply': 'fbn_apply_kernel',
                 'fused_bn_bwd_sums': 'fbn_bwd_partial_kernel',
                 'fused_bn_dx': 'fbn_dx_kernel'}


def resume_rgb(dev, tmp, meta, model_path):
    """(a) The RGB CLI with cmu_train.sh's flags on the entry store: an
    uninterrupted 2-epoch -save_state run with -trace_dir (its first epoch
    traced; (c)); a -save_state -save_every 1 run in a child process,
    killed with SIGKILL in epoch 2 once a snapshot of epoch 2 lands; then
    -resume from its model_1.pth. The resumed run's model_2.pth,
    train_record.pth and full_state/epoch_2.pt must equal the
    uninterrupted run's bit for bit."""
    import re
    import signal

    from pose_tpu_torch import main as cli
    from pose_tpu_torch.ops import fused_bn_cuda, warp_cuda
    from pose_tpu_torch.train import engine, state_io

    save = os.path.join(tmp, 'resume')
    trace_dir = os.path.join(tmp, 'trace')

    def flags(suffix):
        argv = cli_flags(meta, save, model_path)
        argv[argv.index('smoke')] = suffix
        return argv + ['-save_state']

    kernels = {'split_warp': warp_cuda.split_warp, **fused_bn_cuda.KERNELS}
    per_epoch = []
    train = engine.RgbTrainer.train

    def counted(self, epoch, batches):
        for fn in kernels.values():
            fn.launches = 0
        out = train(self, epoch, batches)
        per_epoch.append({k: fn.launches for k, fn in kernels.items()})
        return out

    engine.RgbTrainer.train = counted
    try:
        with bn_pallas():
            t0 = time.perf_counter()
            whole = cli.main(flags('whole') + ['-trace_dir', trace_dir])
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
    finally:
        engine.RgbTrainer.train = train
    without = whole.train_loader.step_ms(1)

    # the preempted run: a child process, killed once epoch 2's first
    # snapshot is in place
    model = flags('cut')[flags('cut').index('-model') + 1]
    run_dir = os.path.join(save, f'{model}-cut')
    mid = os.path.join(run_dir, state_io.SIDECAR, 'mid')
    log_path = os.path.join(tmp, 'cut.log')
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, POSE_TPU_BN='pallas',
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    t0 = time.perf_counter()
    with open(log_path, 'w') as log:
        child = subprocess.Popen(
            [sys.executable, '-m', 'pose_tpu_torch.main']
            + flags('cut') + ['-save_every', '1'], cwd=root, env=env,
            stdout=log, stderr=subprocess.STDOUT)
        landed = None
        try:
            while child.poll() is None and landed is None:
                names = os.listdir(mid) if os.path.isdir(mid) else []
                ids = [int(n[:-3]) for n in names
                       if re.fullmatch(r'\d+\.pt', n)]
                epoch2 = [i for i in ids
                          if i // state_io.MID_EPOCH_RADIX == 2]
                if epoch2:
                    landed = min(epoch2) % state_io.MID_EPOCH_RADIX
                    child.send_signal(signal.SIGKILL)
                else:
                    time.sleep(0.02)
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()
    cut_s = time.perf_counter() - t0
    with open(log_path) as file:
        tail = file.read()[-3000:]
    check(landed is not None and child.returncode == -signal.SIGKILL,
          f'the child run ended with {child.returncode} before a snapshot '
          f'of epoch 2 landed; its output ends:\n{tail}')
    left = sorted(os.listdir(mid))
    print(f'resume (a): the child run killed (SIGKILL) {cut_s:.2f} s after '
          f'its start, once the snapshot before batch {landed} of epoch 2 '
          f'landed; full_state/mid then held {left}', flush=True)

    resume_argv = [a for a in flags('cut') if a != '-pretrain']
    resume_argv[resume_argv.index('-model_path') + 1] = os.path.join(
        run_dir, 'model_1.pth')
    t0 = time.perf_counter()
    with bn_pallas():
        resumed = cli.main(resume_argv + ['-resume', '-save_every', '1'])
        torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    with_every = resumed.train_loader.step_ms(0)

    diffs = {}
    for name in ('model_2.pth', 'train_record.pth',
                 os.path.join(state_io.SIDECAR, 'epoch_2.pt')):
        a, b = (torch.load(os.path.join(save, f'{model}-{s}', name),
                           map_location='cpu', weights_only=True)
                for s in ('whole', 'cut'))
        diffs[name] = tree_diff(a, b)
    print(f'resume (a): uninterrupted run {whole_s:.2f} s, resumed run '
          f'{resumed_s:.2f} s from batch {landed}; differing entries {diffs}; records uninterrupted '
          f'{whole.train[-1]} {whole.test[-1]}, resumed {resumed.train[-1]} '
          f'{resumed.test[-1]}', flush=True)
    print(f'resume (a): ms a train step of epoch 2 at batch {TRAIN_B} (CUDA '
          f'events between batches; the host waits inside a step show): '
          f'-save_state without -save_every {np.median(without):.2f} '
          f'({", ".join(f"{t:.2f}" for t in without)}), with -save_every 1 '
          f'after the resume {np.median(with_every):.2f} '
          f'({", ".join(f"{t:.2f}" for t in with_every)}); '
          f'{snapshot_line(resumed.trainer.snapshot_log)}', flush=True)
    for name, d in diffs.items():
        check(not d, f'resumed {name} differs from the uninterrupted run at '
              f'{d[:8]}')
    check(not os.path.exists(mid), 'the mid-epoch snapshots outlived the '
          'recorded epoch')

    # (c) the trace of the uninterrupted run's first epoch
    check(len(whole.traces) == 1, f'{len(whole.traces)} traces written')
    counts, n_kernels, notes = trace_kernel_counts(
        whole.traces[0], list(TRACE_KERNELS.values()))
    launches = per_epoch[0]
    size = os.path.getsize(whole.traces[0]) / 2 ** 20
    n_steps = notes.count('joint_train_step')
    print(f'resume (c): -trace_dir wrote {os.path.basename(whole.traces[0])}'
          f' ({size:.1f} MiB) for epoch 1: {n_kernels} kernel events, '
          f'{n_steps} joint_train_step ranges; kernel events '
          f'{counts}; launch counters {launches}', flush=True)
    for wrapper, name in TRACE_KERNELS.items():
        check(counts[name] == launches[wrapper] > 0, f'the trace holds '
              f'{counts[name]} {name} events, the counter {launches[wrapper]}')
    check(n_steps == ENTRY_TRAIN // TRAIN_B, f'{n_steps} step ranges')
    return dict(snapshots=resumed.trainer.snapshot_log, without=without,
                with_every=with_every)


class Preempted(Exception):
    pass


class PreemptingLoader:
    """The first `stop_after` batches of a loader, then Preempted; every
    attribute read goes to the loader (the saver reads its epoch)."""

    def __init__(self, inner, stop_after):
        self.__dict__.update(_inner=inner, _stop_after=stop_after)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __len__(self):
        return len(self._inner)

    def __iter__(self):
        for j, batch in enumerate(self._inner):
            if j >= self._stop_after:
                raise Preempted()
            yield batch


def resume_distill(dev, tmp, meta, model_path, stop_after=2):
    """(b) DepthTrainer.distill_train at the depth entry's configuration
    (ntu_train.sh's flags, -do_teach -do_fusion -attention) with
    -semi_teach (a semi stream of batch 16 from the store's train split,
    its own seed) and -save_state -save_every 1, over the NTU store's
    DepthPoseLoader: one uninterrupted epoch; one preempted after
    `stop_after` steps; one resumed from its snapshot. Student state,
    teacher buffers, semi position and records must be equal bit for
    bit."""
    import copy

    from pose_tpu_torch import opts
    from pose_tpu_torch.data import joints, loader
    from pose_tpu_torch.models import build_model, init_weights
    from pose_tpu_torch.train import depth_engine, schedules, state_io

    save = os.path.join(tmp, 'resume_distill')
    info = joints.build_info('h36m')

    def fresh(suffix):
        args = opts.parse(depth_flags(meta, save, model_path, suffix, 1) + [
            '-do_fusion', '-do_teach', '-attention', '-semi_teach',
            '-semi_batch', str(RESUME_SEMI_B), '-save_state', '-save_every',
            '1'])
        student_args = copy.copy(args)
        student_args.depth_only = False
        student = init_weights(build_model(student_args, 'depth'),
                               torch.Generator().manual_seed(SEED))
        trainer = depth_engine.DepthTrainer(args, student, info, device=dev)
        trainer.set_teacher(init_weights(
            build_model(args, 'fusion'),
            torch.Generator().manual_seed(SEED + 1)))
        semi_args = copy.copy(args)
        semi_args.batch_size = args.semi_batch
        trainer.set_semi_loader(loader.DepthPoseLoader(
            semi_args, 'train', info, seed=5, device=dev))
        return args, trainer, loader.DepthPoseLoader(args, 'train', info,
                                                     device=dev)

    def outcome(trainer, record):
        return dict(state=state_io.host_train_state(trainer.state),
                    teacher=state_io.to_host(dict(
                        trainer.teacher.named_buffers())),
                    semi=trainer._get_semi_pos(), record=record)

    with bn_pallas():
        t0 = time.perf_counter()
        args, trainer, batches = fresh('whole')
        lr = schedules.depth_learn_rate(args, 1)
        whole = outcome(trainer, trainer.distill_train(1, batches, lr))
        del trainer, batches
        args, trainer, batches = fresh('cut')
        try:
            trainer.distill_train(1, PreemptingLoader(batches, stop_after),
                                  lr)
            check(False, 'the preempted distillation epoch ran to its end')
        except Preempted:
            pass
        cut_log = list(trainer.snapshot_log)
        del trainer, batches
        args, trainer, batches = fresh('cut')
        trainer._mid_resume_pending = True
        resumed = outcome(trainer, trainer.distill_train(1, batches, lr))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    diff = tree_diff(whole, resumed)
    print(f'resume (b): distillation with -semi_teach at batch {TRAIN_B} '
          f'(semi {RESUME_SEMI_B}): uninterrupted, preempted after '
          f'{stop_after} steps, resumed: {wall:.2f} s in all; semi position '
          f'{resumed["semi"]}; records {whole["record"]} | '
          f'{resumed["record"]}; differing entries {diff[:8]}; the preempted '
          f'run\'s {snapshot_line(cut_log)}', flush=True)
    check(not diff, f'the resumed distillation differs at {diff[:8]}')
    check(len(cut_log) == stop_after, f'{len(cut_log)} snapshots in '
          f'{stop_after} steps')


def qconv_host_us(shapes, n=200):
    """Host µs a QuantizedConv call takes to enqueue, at each distinct conv
    shape (its own input), n calls without a wait; their median."""
    per = []
    for x, _, mod in shapes.values():
        with torch.inference_mode():
            for _ in range(3):
                mod(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                mod(x)
            per.append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
    return float(np.median(per)), per


def int8_conv_race(shapes, n_calls=300):
    """Two threads calling one QuantizedConv (the conv with the largest
    input) back to back, n_calls each, one on the input and one on the
    input with its batch reversed: how many answers of each differ from
    the serial ones. Calls that shared one quantized-input buffer would
    read each other's codes."""
    import threading

    label, (x, _, mod) = max(shapes.items(),
                             key=lambda kv: kv[1][0].numel())
    inputs = [x, torch.flip(x, [0])]
    with torch.inference_mode():
        serial = [mod(t).clone() for t in inputs]
    torch.cuda.synchronize()
    bad = [None, None]

    def loop(k):
        with torch.inference_mode():
            outs = [mod(inputs[k]) for _ in range(n_calls)]
        torch.cuda.synchronize()
        bad[k] = sum(not same_bits(o, serial[k]) for o in outs)

    threads = [threading.Thread(target=loop, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return label, bad


def int8_threads(dev, predictor, scales, batches, n_calls=20):
    """(d) Two threads serving one quantized Predictor at once, n_calls
    batches each on its own input, against the serial answers bit for bit,
    with one conv and one quantize launch a quantized conv a batch; first
    the host µs a QuantizedConv call takes to enqueue, last two threads on
    one QuantizedConv in a tight loop (int8_conv_race)."""
    import threading

    from pose_tpu_torch import quant
    from pose_tpu_torch.ops import int8_conv as i8

    shapes = int8_shapes(predictor, scales, batches[0])
    host_us, per = qconv_host_us(shapes)
    print(f'int8 threads: a QuantizedConv call enqueues in {host_us:.1f} µs '
          f'of host time (median over {len(per)} conv shapes at batch {B}, '
          f'200 calls each; min {min(per):.1f}, max {max(per):.1f})',
          flush=True)
    n_q = len(quant.quantized_convs(predictor._quant_model))
    inputs = batches[:2]
    serial = [predictor.predict_crops(x) for x in inputs]
    fused = i8.quantized_conv
    fused.launches = fused.quantize_launches = 0
    got, errors = [[], []], []

    def serve_one(k):
        try:
            for _ in range(n_calls):
                got[k].append(predictor.predict_crops(inputs[k]))
        except BaseException as e:
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=serve_one, args=(k,))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    launches = (fused.launches, fused.quantize_launches)
    bad = sum(any(not np.array_equal(out[name], serial[k][name])
                  for name in out)
              for k in range(2) for out in got[k])
    print(f'int8 threads: 2 threads x {n_calls} batches of {B} in '
          f'{wall:.2f} s; {bad} of {2 * n_calls} answers differ from the '
          f'serial ones; conv and quantize launches {launches} (want '
          f'{2 * n_calls * n_q} each)', flush=True)
    check(not errors, f'a serving thread raised {errors}')
    check(bad == 0, f'{bad} threaded answers differ from the serial ones')
    check(launches == (2 * n_calls * n_q,) * 2, f'launches {launches}')
    label, race = int8_conv_race(shapes)
    print(f'int8 threads: 2 threads x 300 back-to-back calls of one '
          f'QuantizedConv ({label}): {race} answers differ from the serial '
          f'ones', flush=True)
    check(race == [0, 0], f'{race} threaded QuantizedConv answers differ')
    return host_us


def resume_phase(dev, tmp, meta, model_path, ntu_meta):
    """The resume phase: the determinism probe, (a) the RGB CLI killed and
    resumed with (c) the trace of its uninterrupted twin, (b) the
    distillation preempted and resumed."""
    t0 = time.perf_counter()
    probe = determinism_probe(dev)
    rgb = resume_rgb(dev, tmp, meta, model_path)
    resume_distill(dev, tmp, ntu_meta, model_path)
    print(f'resume: phase {time.perf_counter() - t0:.2f} s', flush=True)
    return probe, rgb


def resume_only(dev):
    """`--only resume,threads` parts: the resume phase on stores of its
    own (the entry phases' stores, written the same way)."""
    from pose_tpu_torch.data import synthetic

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        meta = synthetic.make_cmu_fixture(
            os.path.join(tmp, 'store'), ENTRY_TRAIN, ENTRY_VALID, seed=SEED,
            imshape=ENTRY_HD, workers=os.cpu_count() or 1)
        ntu_meta = synthetic.make_ntu_fixture(
            os.path.join(tmp, 'ntu'), ENTRY_TRAIN, ENTRY_VALID, seed=SEED,
            imshape=ENTRY_HD, depth_imshape=KINECT_DEPTH,
            workers=os.cpu_count() or 1, depth_scene=KINECT_RANGE_M)
        model_path = os.path.join(tmp, 'resnet50.pth')
        torchvision_state(model_path)
        print(f'resume: stores written in {time.perf_counter() - t0:.1f} s',
              flush=True)
        resume_phase(dev, tmp, meta, model_path, ntu_meta)
    return []


def threads_only(dev):
    """`--only threads`: the quantized Predictor's setup and (d)."""
    predictor, batches, scales = quant_setup(dev)[:3]
    int8_threads(dev, predictor, scales, batches[2:])
    return []


def main(argv):
    """No arguments: every phase. `--only
    split,split_depth,stem,banded,int8,resume,threads,export` (any of
    them): the build and those phases (`resume` on stores of its own),
    then the kernel phases' rows, and no result line."""
    only = []
    if argv[:1] == ['--only'] and len(argv) == 2:
        only = argv[1].split(',')
    elif argv:
        print('usage: chip_smoke.py [--only '
              'split,split_depth,stem,banded,int8,resume,threads,export]',
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on an '
              'NVIDIA GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pose_tpu_torch import cuda_build, runtime
    from pose_tpu_torch.ops import (fused_bn_cuda, int8_conv, partial_conv,
                                    stem, warp_banded, warp_cuda)

    t_start = time.perf_counter()
    dev = runtime.resolve_device('cuda')
    print(card_line(), flush=True)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}', flush=True)

    t0 = time.perf_counter()
    sources = ['split_warp', 'fused_bn', 'banded_warp', 'partial_conv',
               'stem_conv', 'int8_conv']
    # the int8 kernels' registers and spills from the build itself (an
    # earlier checkout's builder has no such option)
    if hasattr(cuda_build, 'ptxas_logs'):
        built = cuda_build.compile_sources(sources, verbose=('int8_conv',))
    else:
        built = cuda_build.compile_sources(sources)
    for mod in (warp_cuda, fused_bn_cuda, warp_banded, partial_conv, stem,
                int8_conv):
        mod.build()
    print(f'build: {", ".join(f"{k}.cu {v:.1f} s" for k, v in built.items())}'
          f' (in parallel; {time.perf_counter() - t0:.1f} s in all)',
          flush=True)

    if only:
        # kernel phases alone, for measuring a kernel between full runs
        phases = {'split': split_warp_phase, 'split_depth':
                  split_warp_depth_phase, 'stem': stem_phase,
                  'banded': lambda dev: list(banded_warp_phase(dev).values()),
                  'int8': int8_only, 'resume': resume_only,
                  'threads': threads_only,
                  'export': export_only}
        rows = []
        for p in only:
            row = phases[p](dev)
            rows += row if isinstance(row, list) else [row]
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
    launches, train_items, train_median = train_phase(dev)
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
    pooled = native_pool_line()
    # the predict phase runs on the entry phases' checkpoints and stores
    with tempfile.TemporaryDirectory() as tmp_e, \
            tempfile.TemporaryDirectory() as tmp_d:
        entry = entry_phase(dev, tmp_e)
        depth_entry = depth_entry_phase(dev, tmp_d, pooled)
        resume_phase(dev, tmp_e, os.path.join(tmp_e, 'store',
                                              'metadata.json'),
                     os.path.join(tmp_e, 'resnet50.pth'),
                     os.path.join(tmp_d, 'ntu', 'metadata.json'))
        aug = augment_phase(dev, train_items, train_median)
        int8_rows, predict_stem = predict_phase(dev, tmp_e, tmp_d)
    export = export_phase(dev)
    for row in int8_rows:
        row['launches_by_path']['export'] = export[row['name']]
        row['launches'] = sum(row['launches_by_path'].values())
    check(export['stem_conv'] > 0 and export['int8_conv'] > 0,
          f'the export path launched {export}')
    # the split and stem kernels run on several paths: each path's count,
    # and their sum as the row's launches
    by_path = {'split_warp': {'serve': serve_launches['split_warp'],
                              'train': launches['split_warp'],
                              'distill': distill['split_warp'],
                              'entry': entry['split_warp'],
                              'depth_entry': depth_entry['split_warp'],
                              'augment': aug['split_warp']},
               'split_warp_depth': {'distill': distill['split_warp_depth'],
                                    'partial_depth':
                                        partial['split_warp_depth'],
                                    'depth_entry':
                                        depth_entry['split_warp_depth']},
               'stem_conv': {'serve': serve_launches['stem_conv'],
                             'distill': distill['stem_conv'],
                             'partial_depth': partial['stem_conv'],
                             'entry': entry['stem_conv'],
                             'depth_entry': depth_entry['stem_conv'],
                             'augment_entry': aug['stem_conv'],
                             'predict': predict_stem,
                             'export': export['stem_conv']}}
    kernels += depth_rows + [stem_row] + int8_rows
    for k in kernels:
        if k['name'] in by_path:
            k['launches_by_path'] = by_path[k['name']]
            k['launches'] = sum(by_path[k['name']].values())
    check(entry['stem_conv'] > 0, 'stem_conv was not launched on the entry '
          'point\'s test epochs')
    check(predict_stem > 0, 'stem_conv was not launched on the predict CLI')

    print(f'chip_smoke: every phase in {time.perf_counter() - t_start:.1f} '
          's', flush=True)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
