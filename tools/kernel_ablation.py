"""Where four kernels' time goes on an NVIDIA GPU: the split warp
(pose_tpu_torch/csrc/split_warp.cu), the stem conv (csrc/stem_conv.cu), the
row-shared banded warp (csrc/banded_warp.cu) and the int8 conv
(csrc/int8_conv.cu), each beside variants of it with parts taken out,
every one built with nvcc for sm_90a and timed alone with L2 flushed,
beside a PyTorch call that moves the output's bytes.

    python3 tools/kernel_ablation.py [split,stem,banded,int8,int8_plans]

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

Banded warp, at stage B of the depth stream (64 x 1 x 256^2 f32 planar ->
257^2) and the oracle's shape (64 uint8 512^2 canvases, crops the gate
admits), against a copy of the output:
- full: the row-shared kernel, and its direct (per-pixel) form;
- no_sharing: the row-shared kernel's grid and walk (a warp per output
  row, 32 pixels a slot), each lane computing both of its pass-1 values
  itself (the walk it takes for a row whose slots span too many columns);
- share_all: every row through the ring, slots of up to 64 columns;
- const_maps, no_sharing_const_maps: full and no_sharing with the row and
  column maps replaced by unit-scale constants (no divisions), the taps as
  many.

Int8 conv, the exact form (int32 out) at the five costliest convs of the
quantized ResNet-50 at batch 8, the rgb stem and a layer1 3x3, each with
the planner's plan, against zeroing the output:
- full: the kernel;
- no_a: the input tile's cp.async gathers gone (the producer's address
  arithmetic, its barriers and the weight's TMA stay; the byte path of
  Cin 1 and 3 keeps its loads);
- no_b: the weight tile's TMA gone (its barrier arrival stays);
- no_loads: both;
- no_mma: the wgmma gone (the pipeline, the loads, the epilogue stay);
- skeleton: no_loads and no_mma (barriers, split-K partials, epilogue);
- no_epilogue: the consumers leave after the last stage (no partials, no
  output);
- bare: skeleton without the epilogue (the launch, the barriers, the
  producer's row setup);
- full_ and skeleton_ no_stores (the output's global stores gone),
  no_split_sum (the split-K partials and the cluster barriers gone: every
  split block stores the whole tile).

int8_plans: the exact form under every plan the planner may pick (tile
width x split) at the five costliest convs, each checked equal to the
plain conv, beside the planner's pick.

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


def banded_variants():
    """{name: {file: text}} of the banded warp's variants."""
    src = _read('banded_warp.cu')
    decide = ('const bool share = first.hi < first.lo || first.hi - first.lo '
              '<= kSpan;')
    no_sharing = _replace(src, decide, 'const bool share = false;',
                          'banded_warp.cu')
    share_all = _replace(_replace(src, decide, 'const bool share = true;',
                                  'banded_warp.cu'),
                         'constexpr int kSpan = 40;', 'constexpr int kSpan = 64;',
                         'banded_warp.cu')
    const_maps = {}
    for name, text in (('const_maps', src),
                       ('no_sharing_const_maps', no_sharing)):
        for old, new in (
                ('m.col((float)u)',
                 '__fadd_rn(__fmul_rn((float)u, 0.996f), 0.25f)'),
                ('m.row((float)xs)',
                 '__fadd_rn(__fmul_rn((float)(blockIdx.x * kWarps + '
                 'threadIdx.y), 0.996f), 0.25f)')):
            text = _replace(text, old, new, 'banded_warp.cu')
        const_maps[name] = text
    common = _read('warp_common.cuh')
    return {name: {'banded_warp.cu': text, 'warp_common.cuh': common}
            for name, text in (('full', src), ('no_sharing', no_sharing),
                               ('share_all', share_all),
                               *const_maps.items())}


def int8_variants():
    """{name: {file: text}} of the int8 conv's variants."""
    src = _read('int8_conv.cu')
    gather = 'cp_async<G>(dst + 2048 * i + G * j, src, ok ? G : 0);'
    tma = ('mbar_arrive_tx(full, BN * BK);\n'
           '        tma_load_2d(b_s + st * BN * BK, &wmap, k0, n0, full);')
    mma = ('for (int kk = 0; kk < BK / 32; ++kk) mma<BN>(acc, da + 2 * kk, '
           'db + 2 * kk);')
    no_a = _replace(src, gather, '(void)src;', 'int8_conv.cu')
    no_b = _replace(src, tma, 'mbar_arrive(full);', 'int8_conv.cu')
    no_loads = _replace(no_a, tma, 'mbar_arrive(full);', 'int8_conv.cu')
    no_mma = _replace(src, mma, '', 'int8_conv.cu')
    skeleton = _replace(no_loads, mma, '', 'int8_conv.cu')
    epilogue = 'const int rank = g.split > 1 ? (int)cluster_rank() : 0;'
    leave = ('if (g.split > 1) { cluster_sync(); cluster_sync(); } '
             'return;\n  const int rank = 0;')
    no_epilogue = _replace(src, epilogue, leave, 'int8_conv.cu')
    bare = _replace(skeleton, epilogue, leave, 'int8_conv.cu')
    stores = 'if (row >= g.M || n >= g.Cout) return;'
    split = 'if (g.split > 1) {'
    variants = {'full': src, 'no_a': no_a, 'no_b': no_b,
                'no_loads': no_loads, 'no_mma': no_mma, 'skeleton': skeleton,
                'no_epilogue': no_epilogue, 'bare': bare}
    for base in ('full', 'skeleton'):
        text = variants[base]
        variants[f'{base}_no_stores'] = _replace(text, stores, 'return;',
                                                 'int8_conv.cu')
        # every split block stores the tile; no cluster barriers
        variants[f'{base}_no_split_sum'] = _replace(
            _replace(text, split, 'if (false) {', 'int8_conv.cu'),
            '(j >> 1) % g.split != rank', 'false', 'int8_conv.cu').replace(
            '(jj >> 1) % g.split != rank', 'false')
    return {name: {'int8_conv.cu': text} for name, text in variants.items()}


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


def banded_rows(dev, flush):
    from pose_tpu_torch.ops import warp, warp_banded

    P, I = ctypes.c_void_p, ctypes.c_int
    libs = build('banded_warp', banded_variants(),
                 [P, I, P, P, I, I, I, I, I, I, P])
    for lib in libs.values():
        lib.banded_warp_direct_launch.argtypes = [P, I, P, P] + [I] * 6 + [P]
        lib.full_warp_launch.argtypes = [P, I, P, P] + [I] * 5 + [P]
        lib.full_warp_direct_launch.argtypes = lib.full_warp_launch.argtypes
    rng = np.random.RandomState(chip_smoke.SEED + 7)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 7)
    side, b = chip_smoke.SIDE, chip_smoke.DEPTH_B
    m = warp.split_defaults((side, side))[0]
    canv, ext = chip_smoke.depth_canvases(gen, b, dev)
    homs = chip_smoke.realistic_homs(rng, b, chip_smoke.DEPTH_H, side)
    residual, scale = warp.decompose_homography(
        torch.as_tensor(homs).to(dev), (side, side), m)
    inter = warp.scale_resample_planar(canv, scale, ext, m, torch.float32,
                                       1.0).contiguous()
    full_m = torch.full((b, 2), m, dtype=torch.int32, device=dev)
    homs, _ = chip_smoke.admitted_homs(rng, b, chip_smoke.CANVAS, side)
    u8 = torch.randint(0, 256, (b, chip_smoke.CANVAS, chip_smoke.CANVAS, 3),
                       generator=gen, device=dev, dtype=torch.uint8)
    homs = torch.as_tensor(homs).to(dev)
    full_c = torch.full((b, 2), chip_smoke.CANVAS, dtype=torch.int32,
                        device=dev)
    cases = (
        (f'stage B {b}x1x{m}^2 f32', 'banded_warp', inter, 1,
         warp_banded.pack_scalars(residual, full_m)),
        (f'oracle {b}x{chip_smoke.CANVAS}^2x3 u8', 'full_warp', u8, 3,
         warp_banded.pack_scalars(homs, full_c)))
    for label, entry, src, n_ch, scal in cases:
        out = torch.empty((b, n_ch, side, side), device=dev)
        forms = [(name, lib, entry) for name, lib in libs.items()]
        forms.insert(1, ('direct', libs['full'], entry + '_direct'))
        for name, lib, fn in forms:
            def run():
                if entry == 'banded_warp':
                    err = getattr(lib, f'{fn}_launch')(
                        src.data_ptr(), 1, scal.data_ptr(), out.data_ptr(),
                        b, 1, src.shape[2], src.shape[3], side, side,
                        torch.cuda.current_stream().cuda_stream)
                else:
                    err = getattr(lib, f'{fn}_launch')(
                        src.data_ptr(), 1, scal.data_ptr(), out.data_ptr(),
                        b, src.shape[1], src.shape[2], side, side,
                        torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f'{entry} {name}: launch error {err}')

            ms = chip_smoke.kernel_ms(run, f'{fn}_kernel', 30, flush)
            print(f'{label} {name}: {ms:.5f} ms (profiler records, L2 '
                  'flushed)', flush=True)
        dst = torch.empty_like(out)
        ms = chip_smoke.time_ms(lambda: dst.copy_(out), 30, flush)
        print(f'{label}: a copy of the output ({out.numel() * 4} B read and '
              f'written) {ms:.5f} ms (events)', flush=True)


def int8_rows(dev, flush):
    from pose_tpu_torch.ops import int8_conv as i8

    libs = build('int8_conv', int8_variants(), [ctypes.c_void_p])
    for lib in libs.values():
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # (Cin, H, Cout, kernel, stride, padding, dilation) at batch 8
    for cin, h, cout, k, s, p, d in (
            (2048, 17, 304, 3, 1, 1, 1), (512, 17, 512, 3, 1, 2, 2),
            (512, 17, 512, 3, 1, 1, 1), (1024, 17, 2048, 1, 1, 0, 1),
            (512, 17, 2048, 1, 1, 0, 1), (4, 257, 64, 7, 2, 3, 1),
            (64, 65, 64, 3, 1, 1, 1)):
        geom = i8.Geometry(cout, cin, (k, k), (s, s), (p, p), (d, d))
        x = torch.randint(-127, 128, (8, cin, h, h), generator=g,
                          device=dev).to(torch.int8).contiguous(
            memory_format=torch.channels_last)
        w = i8.pack_weight(torch.randint(-127, 128, (cout, cin, k, k),
                                         generator=g, device=dev).to(
            torch.int8))
        oh, ow = geom.out_hw(h, h)
        out = torch.empty((8, oh, ow, cout), dtype=torch.int32, device=dev)
        plan = i8.plan(8 * oh * ow, cout, w.shape[1], sms)
        label = (f'int8 8x{cin}x{h}^2 -> {cout} {k}x{k}/{s} d{d} (BN '
                 f'{plan.bn}, split {plan.split})')
        for name, lib in libs.items():
            ms = chip_smoke.kernel_ms(
                lambda: i8.launch(x, w, out, geom, plan, lib),
                'int8_conv_kernel', 30, flush)
            print(f'{label} {name}: {ms:.5f} ms (profiler records, L2 '
                  'flushed)', flush=True)
        ms = chip_smoke.time_ms(out.zero_, 30, flush)
        print(f'{label}: zeroing the output ({out.numel() * 4} B written) '
              f'{ms:.5f} ms (events)', flush=True)


def int8_plan_rows(dev, flush):
    """The int8 conv's exact form under every plan (tile width x split) at
    the five costliest convs of the quantized ResNet-50 at batch 8, beside
    the planner's pick: the data ops/int8_conv.py's STAGE_COST, BLOCK_COST
    and REDUCE_COST are fitted to."""
    from pose_tpu_torch.ops import int8_conv as i8

    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for cin, h, cout, k, s, p, d in (
            (2048, 17, 304, 3, 1, 1, 1), (512, 17, 512, 3, 1, 2, 2),
            (1024, 17, 2048, 1, 1, 0, 1), (512, 17, 2048, 1, 1, 0, 1),
            (256, 17, 256, 3, 1, 1, 1)):
        geom = i8.Geometry(cout, cin, (k, k), (s, s), (p, p), (d, d))
        x = torch.randint(-127, 128, (8, cin, h, h), generator=g,
                          device=dev).to(torch.int8).contiguous(
            memory_format=torch.channels_last)
        w8 = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                           device=dev).to(torch.int8)
        w = i8.pack_weight(w8)
        oh, ow = geom.out_hw(h, h)
        m, total = 8 * oh * ow, -(-w.shape[1] // i8.BK)
        ref = i8.int8_conv_plain(x, w8, geom).permute(0, 2, 3, 1)
        out = torch.empty((8, oh, ow, cout), dtype=torch.int32, device=dev)
        times = []
        for bn in i8.PLAN_NS:
            if bn > 64 and 2 * cout <= bn:
                continue
            for split in range(1, min(total, i8.MAX_SPLIT) + 1):
                if total % split or (split > 1 and total // split
                                     < i8.MIN_SPLIT_STEPS):
                    continue
                plan = i8.make_plan(m, cout, w.shape[1], bn, split)
                i8.launch(x, w, out, geom, plan)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise RuntimeError(f'int8 plan {bn}/{split} differs from '
                                       f'the plain conv at {geom}')
                times.append((chip_smoke.kernel_ms(
                    lambda: i8.launch(x, w, out, geom, plan),
                    'int8_conv_kernel', 20, flush), bn, split))
        times.sort()
        pick = i8.plan(m, cout, w.shape[1], sms)
        print(f'int8 plans 8x{cin}x{h}^2 -> {cout} {k}x{k} d{d}: planner '
              f'BN {pick.bn} split {pick.split}; ' + ', '.join(
                  f'{bn}/{split} {ms:.5f}' for ms, bn, split in times) +
              ' ms (profiler records, L2 flushed; equal to the plain conv)',
              flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print('kernel_ablation: needs an NVIDIA GPU', file=sys.stderr)
        return 1
    rows = {'split': split_rows, 'stem': stem_rows, 'banded': banded_rows,
            'int8': int8_rows, 'int8_plans': int8_plan_rows}
    names = argv[0].split(',') if argv else list(rows)
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device('cuda')
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for name in names:
        rows[name](dev, flush)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
