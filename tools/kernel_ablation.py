"""Where two kernels' time goes on an NVIDIA GPU: the split warp
(pose_tpu_torch/csrc/split_warp.cu) and the stem conv (csrc/stem_conv.cu),
each beside variants of it with parts taken out, every one built with nvcc
for sm_90a and timed alone with L2 flushed, beside a PyTorch call that
moves the output's bytes.

    python3 tools/kernel_ablation.py

A diagnostic, not kept in step with the kernels: it makes the variants by
replacing text of the sources and stops with an error when a text it looks
for is gone. The variants compute other functions; only their times are
read.

Split warp, at the training shape (64 uint8 512^2 canvases, RGB) and the
depth shape (64 f32 424x512 canvases), against a copy of the output:
- full: the kernel;
- fastdiv: its maps' IEEE divisions replaced by __fdividef;
- no_stage_a_b: no staging, no stage A, stage B replaced by a sum of the
  phase-1 taps (what remains: scalars, phase 1's maps, the output);
- no_stage_a_b_fastdiv: both;
- skeleton: phase 1's maps replaced by constants too (the scalars, the
  block's reductions and the output writes).

Stem conv, the model route at the test epoch's shape (64 x 4 x 257^2
channels_last bf16 in, bf16 NHWC out), against zeroing the output:
- full: the kernel;
- no_mma: the k-loop (fragment reads and mma.sync) gone, the sums left at
  their constant 0 (what remains: the weight and input staging, the
  output writes through shared memory);
- writes_only: the staging gone too (the output writes alone).

Builds go to pose_tpu_torch/_build/ablation/ (gitignored). Needs one card.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

CSRC = os.path.join(ROOT, 'pose_tpu_torch', 'csrc')
BUILD = os.path.join(ROOT, 'pose_tpu_torch', '_build', 'ablation')


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _replace(text, old, new, where):
    if old not in text:
        raise RuntimeError(f'{where} no longer has {old!r}')
    return text.replace(old, new)


def split_variants():
    """{name: {file: text}} of the split warp's variants."""
    src, common = _read('split_warp.cu'), _read('warp_common.cuh')
    taps = 'two_pass_taps(s.h, m, m, lim, lim, u, v, tp[k]);'
    stage = 'if (staged && np > 0) {'
    stage_b = 'two_pass_apply<C>(tp[k], sa, acc);'
    for anchor in (taps, stage, stage_b):
        _replace(src, anchor, anchor, 'split_warp.cu')
    no_stage = src.replace(stage, 'if (false) {').replace(
        stage_b, 'for (int c = 0; c < C; ++c) acc[c] = tp[k].wx[0] + '
        'tp[k].wy[0][1] + (float)(tp[k].sy0[0] + tp[k].sx0);')
    skeleton = no_stage.replace(taps, (
        'tp[k].sx0 = u; tp[k].wx[0] = (float)v; tp[k].wx[1] = 0.f; '
        'tp[k].sy0[0] = v; tp[k].sy0[1] = v; tp[k].wy[0][0] = 1.f; '
        'tp[k].wy[0][1] = 0.f; tp[k].wy[1][0] = 0.f; tp[k].wy[1][1] = 0.f;'))
    fastdiv = _replace(common, '__fdiv_rn(', '__fdividef(', 'warp_common.cuh')
    return {name: {'split_warp.cu': s, 'warp_common.cuh': h}
            for name, (s, h) in (('full', (src, common)),
                                 ('fastdiv', (src, fastdiv)),
                                 ('no_stage_a_b', (no_stage, common)),
                                 ('no_stage_a_b_fastdiv', (no_stage, fastdiv)),
                                 ('skeleton', (skeleton, common)))}


def stem_variants():
    """{name: {file: text}} of the stem conv's variants."""
    src = _read('stem_conv.cu')
    no_mma = _replace(src, 'for (int s = 0; s < L::KSTEPS; ++s) {',
                      'for (int s = 0; s < 0; ++s) {', 'stem_conv.cu')
    writes = _replace(no_mma, 'for (int i0 = 0; i0 < kW4; i0 +=',
                      'for (int i0 = kW4; i0 < kW4; i0 +=', 'stem_conv.cu')
    writes = _replace(writes, 'for (int i0 = 0; i0 < npix; i0 +=',
                      'for (int i0 = npix; i0 < npix; i0 +=', 'stem_conv.cu')
    return {name: {'stem_conv.cu': text}
            for name, text in (('full', src), ('no_mma', no_mma),
                               ('writes_only', writes))}


def build(kernel, found, argtypes):
    """One nvcc per variant of `kernel`, all started together ->
    {name: CDLL}."""
    from pose_tpu_torch import cuda_build

    procs = {}
    for name, files in found.items():
        d = os.path.join(BUILD, kernel, name)
        os.makedirs(d, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, fname), 'w') as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, '-o',
             os.path.join(d, f'{kernel}.so'), os.path.join(d, f'{kernel}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {kernel} {name}:\n{out}')
        lib = ctypes.CDLL(os.path.join(BUILD, kernel, name, f'{kernel}.so'))
        getattr(lib, f'{kernel}_launch').argtypes = argtypes
        libs[name] = lib
    return libs


def split_rows(dev, flush):
    from pose_tpu_torch.ops import warp, warp_cuda

    P, I = ctypes.c_void_p, ctypes.c_int
    libs = build('split_warp', split_variants(),
                 [P, I, P, P] + [I] * 7 + [ctypes.c_float, I, I, P, P])
    rng = np.random.RandomState(chip_smoke.SEED)
    side = chip_smoke.SIDE
    m = warp.split_defaults((side, side))[0]
    for label, n_ch in (('rgb 64x512^2x3 u8', 3), ('depth 64x424x512 f32', 1)):
        b = chip_smoke.TRAIN_B
        if n_ch == 3:
            frames, homs, ext = chip_smoke.make_frames(
                rng, b, chip_smoke.CANVAS, side, True)
            canv = torch.as_tensor(frames).to(dev)
            post, bf16 = 1 / 255, 1
        else:
            gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
            canv, ext = chip_smoke.depth_canvases(gen, b, dev)
            homs = chip_smoke.realistic_homs(rng, b, chip_smoke.DEPTH_H, side)
            post, bf16 = 1.0, 0
        ext = torch.as_tensor(ext).to(dev)
        residual, scale = warp.decompose_homography(
            torch.as_tensor(homs).to(dev), (side, side), m)
        scal = warp_cuda.pack_scalars(residual, scale, ext)
        over = torch.zeros(1, dtype=torch.int32, device=dev)
        out = torch.empty((b, n_ch, side, side), device=dev)
        for name, lib in libs.items():
            def run():
                err = lib.split_warp_launch(
                    canv.data_ptr(), int(canv.dtype == torch.uint8),
                    scal.data_ptr(), out.data_ptr(), b, canv.shape[1],
                    canv.shape[2], n_ch, m, side, side, post, bf16,
                    warp_cuda.SMEM_BUDGET, over.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f'split {name}: launch error {err}')

            ms = chip_smoke.kernel_ms(run, 'split_warp_kernel', 30, flush)
            print(f'{label} {name}: {ms:.5f} ms (profiler records, L2 '
                  'flushed)', flush=True)
        dst = torch.empty_like(out)
        ms = chip_smoke.time_ms(lambda: dst.copy_(out), 30, flush)
        print(f'{label}: a copy of the output ({out.numel() * 4} B read and '
              f'written) {ms:.5f} ms (events)', flush=True)


def stem_rows(dev, flush):
    from pose_tpu_torch.ops import stem

    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build('stem_conv', stem_variants(),
                 [P, L, L, L, L, P, P, I, I, I, I, I, P])
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    b, side = chip_smoke.TRAIN_B, chip_smoke.SIDE
    x = torch.randn((b, 4, side, side), generator=g, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = (torch.randn((7, 7, 4, 64), generator=g, device=dev)
         * 0.05).to(torch.bfloat16)
    wp = stem.pack_weight(w)
    out = torch.empty(stem.out_shape(x), dtype=torch.bfloat16, device=dev)
    label = f'stem {b}x4x{side}^2 channels_last bf16 -> bf16 NHWC'
    for name, lib in libs.items():
        def run():
            err = lib.stem_conv_launch(
                x.data_ptr(), *x.stride(), wp.data_ptr(), out.data_ptr(), 1,
                b, 4, side, side, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f'stem {name}: launch error {err}')

        ms = chip_smoke.kernel_ms(run, 'stem_conv_kernel', 30, flush)
        print(f'{label} {name}: {ms:.5f} ms (profiler records, L2 flushed)',
              flush=True)
    ms = chip_smoke.time_ms(out.zero_, 30, flush)
    print(f'{label}: zeroing the output ({out.numel() * 2} B written) '
          f'{ms:.5f} ms (events)', flush=True)


def main():
    if not torch.cuda.is_available():
        print('kernel_ablation: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device('cuda')
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    split_rows(dev, flush)
    stem_rows(dev, flush)
    return 0


if __name__ == '__main__':
    sys.exit(main())
