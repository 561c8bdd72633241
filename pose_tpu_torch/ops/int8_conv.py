"""The int8 convolution of the quantized serving forward, and the quantize
and dequant around it.

JAX runs the body of its conv interceptor (pose_tpu/quant.py:212-235):
quantize the input, XLA's `lax.conv_general_dilated(xq, wq,
preferred_element_type=int32)`, dequant, bias, cast. PyTorch has no CUDA
int8 convolution with int32 sums, so the port has its own kernels
(`csrc/int8_conv.cu`: a quantize pass and a wgmma s8 implicit GEMM with a
TMA ring, split-K across a thread-block cluster and the dequant in its
epilogue).

- `Geometry` — what a conv computes besides its operands: Cout, Cin, the
  kernel size, stride, padding and dilation per axis (symmetric padding,
  one group);
- `pack_weight(wq_oihw)` — the kernel's (Npad, Kpad) int8 weight: row co
  holds w[co] in the order (kh, kw, ci), K = KH KW Cin padded with zeros
  to a multiple of 64, Cout padded with zero rows to a multiple of 64;
  `unpack_weight` gives the OIHW weight back;
- `plan(m, n, kpad, sms)` — the kernel's tile width and split-K for a
  conv with M output pixels, N = Cout and the packed Kpad on a card with
  `sms` SMs;
- `quantized_conv(x, w_packed, geom, x_scale, scale, bias, acc_dtype)` —
  one QuantizedConv: x (B, Cin, H, W) bf16 or f32 in any strides ->
  (B, Cout, OH, OW) in x's dtype, channels_last. On the card one C call
  launches the quantize pass and the conv with the fused epilogue (and
  counts them in `.launches` and `.quantize_launches`) or raises; on the
  CPU it runs `quantized_conv_plain`. The model calls it as the
  `pose_tpu_torch::quantized_conv` op (`ops/library.py`). Inside a
  CUDA-graph capture its input scratch is the graph's (`graph_scratch`);
- `quantized_conv_plain` — the plain chain: quantize (a true division by
  the 0-d scale, round half to even, clamp), `int8_conv_plain`, the
  int32 sums rounded to bf16 when acc_dtype is bf16, times `scale`, plus
  `bias`, cast to x's dtype;
- `int8_conv(xq, w_packed, geom)` — the exact form: xq (B, Cin, H, W)
  int8 in any strides (a channels_last tensor is NHWC memory, read in
  place) -> (B, Cout, OH, OW) int32, the channels_last view of the
  kernel's NHWC output, the same kernel with int32 out. On the card it
  launches (and counts in `.launches`) or raises; on the CPU it runs
  `int8_conv_plain`;
- `int8_conv_plain(xq, w_oihw, geom)` — F.conv2d in f64 on the int8
  values: every product and partial sum is an integer below 2^53 in
  magnitude (|sum| <= 127^2 K), so the f64 sum is exact and equals the
  kernel's int32 sum. (In f32 it is not once K > 1040.)

Importing this module compiles nothing and needs no GPU.
"""

import array
import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import cuda_build
from ..cuda_build import check_launch, cuda_stream

_lib = None
_P = ctypes.c_void_p
TILE_N, TILE_K = 64, 64                 # pack_weight's padding
BM, BK = 128, 128                       # the kernel's block rows, K stage
PLAN_NS = (64, 128, 256)                # the kernel's tile widths
MIN_SPLIT_STEPS = 4                     # K stages a split keeps at least
MAX_SPLIT = 8                           # a split tile is one cluster
BLOCKS_PER_SM = {64: 2, 128: 1, 256: 1}  # the kernel's occupancy by width
# the planner's costs, in units of a 128 x 128 x 128 stage: a K stage by
# tile width (the card is bound by the operand bytes a stage brings to
# the SM), a block's prologue and epilogue, and a split's partials
# (exchanged within the tile's cluster);
# fitted to the kernel's times over every plan at the costliest convs of
# the quantized ResNet-50 at batch 8 on an NVIDIA H100 80GB HBM3
# (`python3 tools/kernel_ablation.py int8_plans`)
STAGE_COST = {64: 0.5, 128: 1.0, 256: 1.3}
BLOCK_COST = 6.0
REDUCE_COST = 0.5
H100_SMS = 132
MAX_GRID_YZ = 65535
_scratch = threading.local()
_sms = {}
# the launch counters are read-modify-writes that threads share
_count_lock = threading.Lock()


class Geometry(NamedTuple):
    cout: int
    cin: int
    kernel: tuple      # (KH, KW)
    stride: tuple
    padding: tuple
    dilation: tuple

    @property
    def k(self):
        return self.kernel[0] * self.kernel[1] * self.cin

    def out_hw(self, h, w):
        (kh, kw), (sh, sw) = self.kernel, self.stride
        (ph, pw), (dh, dw) = self.padding, self.dilation
        return ((h + 2 * ph - dh * (kh - 1) - 1) // sh + 1,
                (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1)


def _ceil(n, m):
    return -(-n // m) * m


def pack_weight(wq_oihw):
    """(Cout, Cin, KH, KW) int8 -> the kernel's (Npad, Kpad) int8 weight:
    row co is w[co] in the order (kh, kw, ci), zero-padded to Kpad (a
    multiple of 64) and Npad (a multiple of 64) rows."""
    cout = wq_oihw.shape[0]
    k = wq_oihw[0].numel()
    packed = torch.zeros((_ceil(cout, TILE_N), _ceil(k, TILE_K)),
                         dtype=torch.int8, device=wq_oihw.device)
    packed[:cout, :k] = wq_oihw.permute(0, 2, 3, 1).reshape(cout, k)
    return packed


def unpack_weight(w_packed, geom):
    """pack_weight's inverse: (Cout, Cin, KH, KW) int8."""
    kh, kw = geom.kernel
    return w_packed[:geom.cout, :geom.k].reshape(
        geom.cout, kh, kw, geom.cin).permute(0, 3, 1, 2)


def int8_conv_plain(xq, w_oihw, geom):
    """The plain version: (B, Cin, H, W) int8 x (Cout, Cin, KH, KW) int8 ->
    (B, Cout, OH, OW) int32, exact (f64 sums of integers below 2^53)."""
    out = F.conv2d(xq.double(), w_oihw.double(), stride=geom.stride,
                   padding=geom.padding, dilation=geom.dilation)
    return out.to(torch.int32)


def quantized_conv_plain(x, w_packed, geom, x_scale, scale, bias,
                         acc_dtype):
    """The plain chain of one QuantizedConv (JAX's interceptor body,
    pose_tpu/quant.py:212-235): x_scale a 0-d f32 tensor (a true
    division, never a reciprocal multiply), scale (Cout, 1, 1) f32, bias
    (Cout, 1, 1) or None -> (B, Cout, OH, OW) in x's dtype,
    channels_last."""
    xq = torch.clamp(torch.round(x.float() / x_scale), -127, 127)
    y = int8_conv_plain(xq.to(torch.int8), unpack_weight(w_packed, geom),
                        geom)
    if acc_dtype == torch.bfloat16:
        y = y.to(torch.bfloat16)
    y = y.float() * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


# ------------------------------------------------------------ the planner


class Plan(NamedTuple):
    bn: int            # output channels a block
    split: int         # blocks a tile along K, one cluster
    steps: int         # K stages of BK bytes each split sums
    tiles_m: int
    tiles_n: int


@functools.lru_cache(maxsize=None)
def plan(m, n, kpad, sms=H100_SMS):
    """The tile width and split-K of a conv with m output pixels, n output
    channels and the packed weight's kpad: the plan of least estimated
    time, counted in waves of blocks (BLOCKS_PER_SM an SM, sharing it)
    times each block's K stages, plus the split's partials, which every
    block writes and the tile's other blocks read. A split divides the K
    stages, keeps MIN_SPLIT_STEPS of them and is at most MAX_SPLIT; ties
    go to the smaller split, then the wider tile."""
    total = -(-kpad // BK)
    tiles_m = -(-m // BM)
    best = None
    for bn in PLAN_NS:
        if bn > 64 and 2 * n <= bn:
            continue
        tiles_n = -(-n // bn)
        tiles = tiles_m * tiles_n
        for split in range(1, min(total, MAX_SPLIT) + 1):
            if total % split or (split > 1
                                 and total // split < MIN_SPLIT_STEPS):
                continue
            if tiles_n > MAX_GRID_YZ:
                continue
            blocks = tiles * split
            bps = BLOCKS_PER_SM[bn]
            waves = -(-blocks // (sms * bps))
            occupancy = min(bps, -(-blocks // sms))
            reduce = REDUCE_COST * bn / 128 if split > 1 else 0.0
            cost = (waves * (total // split * STAGE_COST[bn] * occupancy
                             + BLOCK_COST + reduce) + (split - 1) * reduce)
            key = (cost, split, -bn)
            if best is None or key < best[0]:
                best = (key, make_plan(m, n, kpad, bn, split))
    if best is None:
        raise ValueError(f'int8 conv: no plan for M {m}, N {n}, Kpad {kpad}')
    return best[1]


def make_plan(m, n, kpad, bn, split):
    """The Plan of tile width bn and `split` (which divides the K
    stages) for the conv of plan()."""
    total = -(-kpad // BK)
    return Plan(bn, split, total // split, -(-m // BM), -(-n // bn))


# ------------------------------------------------------------- the kernel


def build():
    """Compile csrc/int8_conv.cu for sm_90a (once per source content, see
    cuda_build) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load('int8_conv')
    for fn in (lib.int8_conv_launch, lib.quantized_conv_launch):
        fn.argtypes = [_P]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check_weight(w_packed, geom, dev, name):
    want = (_ceil(geom.cout, TILE_N), _ceil(geom.k, TILE_K))
    if (tuple(w_packed.shape) != want or w_packed.dtype != torch.int8
            or w_packed.device != dev or not w_packed.is_contiguous()
            or w_packed.data_ptr() % 16):
        raise ValueError(f'{name}: w_packed must be pack_weight\'s '
                         f'contiguous, 16-byte aligned {want} int8 on {dev}, '
                         f'got {tuple(w_packed.shape)} {w_packed.dtype}')


@functools.lru_cache(maxsize=None)
def _steps_ok(geom):
    return min(geom.stride + geom.dilation) >= 1


def _check_input(x, geom, dtypes, name):
    """Raise on an input the kernel does not take; else (OH, OW)."""
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {x.device}')
    if x.dim() != 4 or x.dtype not in dtypes or x.shape[1] != geom.cin:
        raise ValueError(f'{name}: input must be (B, {geom.cin}, H, W) '
                         f'{" or ".join(map(str, dtypes))}, got '
                         f'{tuple(x.shape)} {x.dtype}')
    if min(x.stride()) < 0 or not _steps_ok(geom):
        raise ValueError(f'{name}: strides {x.stride()}, geometry {geom}')
    b, _, h, w = x.shape
    oh, ow = geom.out_hw(h, w)
    if b < 1 or oh < 1 or ow < 1:
        raise ValueError(f'{name}: empty output for {tuple(x.shape)}, '
                         f'{geom}')
    return oh, ow


def _check(xq, w_packed, geom):
    _check_weight(w_packed, geom, xq.device, 'int8_conv')
    return _check_input(xq, geom, (torch.int8,), 'int8_conv')


def _buffer(dev, stream, nbytes):
    """The address of a scratch buffer of at least nbytes on dev for the
    quantized input, kept for one stream of the calling thread: the calls
    of a thread on a stream run in order, so each may reuse it, and no
    other thread's call reads or frees it. Inside a CUDA-graph capture the
    call takes a buffer of its own from the graph's memory pool, kept in
    the list of the enclosing `graph_scratch()` (the graph's owner keeps
    it as long as the graph): a replay reads that address, so it must not
    be the thread's eager buffer, which the thread's next eager call
    overwrites or a larger one replaces."""
    if torch.cuda.is_current_stream_capturing():
        buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        kept = getattr(_scratch, 'graph', None)
        if kept is not None:
            kept.append(buf)
        return buf.data_ptr()
    bufs = getattr(_scratch, 'bufs', None)
    if bufs is None:
        bufs = _scratch.bufs = {}
    key = (dev, stream)
    buf = bufs.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                          device=dev)
        bufs[key] = buf
    return buf.data_ptr()


@contextlib.contextmanager
def graph_scratch():
    """Around a CUDA-graph capture in the calling thread: yields the list
    that keeps the scratch buffers the captured quantized_conv calls take,
    which the caller keeps alive with the graph."""
    kept = _scratch.graph = []
    try:
        yield kept
    finally:
        _scratch.graph = None


def _on(dev):
    """The launch's device context: none where `dev` is current."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _plan_for(dev, m, cout, kpad):
    sms = _sms.get(dev)
    if sms is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _sms[dev] = sms
    return plan(m, cout, kpad, sms)


def launch(xq, w_packed, out, geom, p=None, lib=None):
    """One bare launch of the exact form into `out` (B, OH, OW, Cout)
    int32, no checks and no count; `p` a Plan in place of plan()'s, `lib`
    another build of the source (tools/kernel_ablation.py)."""
    b, cin, h, w = xq.shape
    oh, ow = out.shape[1:3]
    if p is None:
        p = _plan_for(xq.device, b * oh * ow, geom.cout, w_packed.shape[1])
    args = array.array('q', (
        xq.data_ptr(), *xq.stride(), w_packed.data_ptr(), out.data_ptr(), b,
        cin, h, w, geom.cout, oh, ow, *geom.kernel, *geom.stride,
        *geom.padding, *geom.dilation, w_packed.shape[1], p.bn, p.split,
        cuda_stream(xq)))
    lib = build() if lib is None else lib
    check_launch(lib, lib.int8_conv_launch(args.buffer_info()[0]),
                 'int8_conv')


def int8_conv(xq, w_packed, geom):
    """xq (B, Cin, H, W) int8, w_packed = pack_weight(w) -> (B, Cout, OH, OW)
    int32 (channels_last): the kernel on the card, the plain version on the
    CPU."""
    if xq.device.type == 'cpu':
        out = int8_conv_plain(xq, unpack_weight(w_packed, geom), geom)
        return out.contiguous(memory_format=torch.channels_last)
    oh, ow = _check(xq, w_packed, geom)
    out = torch.empty((xq.shape[0], oh, ow, geom.cout), dtype=torch.int32,
                      device=xq.device)
    with _on(xq.device):
        launch(xq, w_packed, out, geom)
    with _count_lock:
        int8_conv.launches += 1
    return out.permute(0, 3, 1, 2)


int8_conv.launches = 0

_FLOATS = (torch.bfloat16, torch.float32)


def _check_fused(x, w_packed, geom, x_scale, scale, bias, acc_dtype):
    """Raise on arguments the kernels do not take; else (OH, OW)."""
    dev = x.device
    _check_weight(w_packed, geom, dev, 'quantized_conv')
    cout = geom.cout
    if scale is None:
        raise ValueError('quantized_conv: scale is required')
    if (x_scale.dim() or x_scale.dtype != torch.float32
            or x_scale.device != dev):
        raise ValueError(f'quantized_conv: x_scale must be a 0-d float32 '
                         f'tensor on {dev}, got {tuple(x_scale.shape)} '
                         f'{x_scale.dtype} on {x_scale.device}')
    for name, t, dtypes in (('scale', scale, (torch.float32,)),
                            ('bias', bias, _FLOATS)):
        if t is not None and (t.numel() != cout or t.dtype not in dtypes
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f'quantized_conv: {name} must be {cout} '
                             f'contiguous {" or ".join(map(str, dtypes))} on '
                             f'{dev}, got {tuple(t.shape)} {t.dtype} on '
                             f'{t.device}')
    if acc_dtype is not torch.int32 and acc_dtype is not torch.bfloat16:
        raise ValueError(f'quantized_conv: acc_dtype int32 or bfloat16, not '
                         f'{acc_dtype}')
    return _check_input(x, geom, _FLOATS, 'quantized_conv')


def quantized_conv(x, w_packed, geom, x_scale, scale, bias, acc_dtype):
    """x (B, Cin, H, W) bf16 or f32 -> (B, Cout, OH, OW) in x's dtype,
    channels_last: quantize with the 0-d x_scale, the int8 conv with exact
    int32 sums (rounded to bf16 when acc_dtype is bf16), times scale
    (Cout,) f32, plus bias (Cout,) or None. On the card one C call
    launches the quantize pass and the conv; on the CPU the plain
    chain."""
    if x.device.type == 'cpu':
        return quantized_conv_plain(x, w_packed, geom, x_scale, scale, bias,
                                    acc_dtype)
    oh, ow = _check_fused(x, w_packed, geom, x_scale, scale, bias,
                          acc_dtype)
    b, cin, h, w = x.shape
    dev = x.device
    p = _plan_for(dev, b * oh * ow, geom.cout, w_packed.shape[1])
    out = torch.empty((b, oh, ow, geom.cout), dtype=x.dtype, device=dev)
    stream = cuda_stream(x)
    args = array.array('q', (
        x.data_ptr(), *x.stride(), w_packed.data_ptr(), out.data_ptr(), b,
        cin, h, w, geom.cout, oh, ow, *geom.kernel, *geom.stride,
        *geom.padding, *geom.dilation, w_packed.shape[1], p.bn, p.split,
        stream, x.dtype == torch.bfloat16,
        x_scale.data_ptr(), _buffer(dev, stream, b * h * w * cin),
        scale.data_ptr(), 0 if bias is None else bias.data_ptr(),
        bias is not None and bias.dtype == torch.bfloat16,
        acc_dtype == torch.bfloat16))
    with _on(x.device):
        err = build().quantized_conv_launch(args.buffer_info()[0])
    check_launch(_lib, err, 'quantized_conv')
    with _count_lock:
        quantized_conv.quantize_launches += 1
        quantized_conv.launches += 1
    return out.permute(0, 3, 1, 2)


quantized_conv.launches = 0
quantized_conv.quantize_launches = 0
