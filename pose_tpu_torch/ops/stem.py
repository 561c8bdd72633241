"""The stem convolution, 7x7 stride 2 (port of pose_tpu/ops/stem_pallas.py).

- `plan` and `pad_planar` — the static geometry and the zero-padded planar
  input of JAX's kernel (stem_pallas.py:43-60);
- `stem_conv_fwd(x_padded, w, side_in)` — JAX's entry (stem_pallas.py:124)
  and contract: x (B, Cin, Hp, Wp) bf16 as `pad_planar` makes it, w (7, 7,
  Cin, 64); returns (B, OH, OH, 64) f32 NHWC, each output the f32 sum of
  bf16 x bf16 products;
- `pack_weight(w_hwio)` — the (K, 64) bf16 weight of the kernel's
  implicit GEMM: K in the order (kh, kw, ci) with kw padded to 8 and ci to
  4 (K = 224 for Cin 3 and 4), or (kh, kw) padded to 8 x 8 for Cin 1 (K =
  64); every padded row zero (`K_LAYOUT`);
- `stem_conv(x, w_hwio, out_dtype, w_packed=None)` — the wrapper of the
  hand-written kernel (`csrc/stem_conv.cu`, the port of `_stem_kernel`
  :63, a tensor-core implicit GEMM): x (B, Cin, H, W) bf16 in any strides
  (the kernel reads through them, with the 3-pixel zero border in its
  index math, so neither a padded copy nor a layout change is made), out
  (B, OH, OW, 64) f32 or bf16 (the f32 sum rounded once). On the card it
  launches the kernel (and counts it in `.launches`) or raises; on the CPU
  it runs `stem_conv_plain`. `w_packed` is `pack_weight(w_hwio)` where
  the caller keeps it;
- `stem_conv_plain(x, w)` — the plain version, F.conv2d on the f32 values
  of the bf16 operands: their products are exact in f32, so it is the same
  f32 sum in another order (TF32 stays off, runtime.no_tf32); the
  kernel's tensor-core sums are within K * 2^-23 of its sum of |terms|;
- `StemConv` — the model's non-partial stem (`conv1`, the fusion net's
  `conv2`): an nn.Conv2d whose forward takes the kernel route when the
  input and weight are bf16, autograd records nothing and Cin is 1, 3 or 4
  (JAX's kernel has no backward), and F.conv2d otherwise.

Importing this module compiles nothing and needs no GPU.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import cuda_build
from ..cuda_build import check_launch, cuda_stream

_lib = None
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
CIN = (1, 3, 4)
COUT = 64
# the kernel's K order per Cin: (kh, kw, ci) padded to these sizes
K_LAYOUT = {1: (8, 8, 1), 3: (7, 8, 4), 4: (7, 8, 4)}


def plan(side_in):
    """(oh, tiles, hp, wp, wh) of JAX's kernel for an odd side_in: output
    side, 8-row tiles, padded planar height and width, half width."""
    oh = (side_in + 2 * 3 - 7) // 2 + 1
    tiles = (oh + 7) // 8
    hp = 16 * (tiles - 1) + 24
    wh = oh + 4
    return oh, tiles, hp, 2 * wh, wh


def pad_planar(x_planar, side_in):
    """(B, Cin, S, S) -> (B, Cin, Hp, Wp), zero-padded with the conv's
    3-pixel border at offset (3, 3)."""
    _, _, hp, wp, _ = plan(side_in)
    s = x_planar.shape[-1]
    return F.pad(x_planar, (3, wp - s - 3, 3, hp - s - 3))


def stem_conv_plain(x, w):
    """The plain version: x (B, Cin, H, W), w (64, Cin, 7, 7) OIHW, any
    float dtypes -> (B, 64, OH, OW) f32."""
    return F.conv2d(x.float(), w.float(), stride=2, padding=3)


def pack_weight(w_hwio):
    """(7, 7, Cin, 64) -> the kernel's (K, 64) bf16 weight: rows in the
    order (kh, kw, ci) of `K_LAYOUT[Cin]`, the padded ones zero."""
    cin = w_hwio.shape[2]
    kh, kw, cp = K_LAYOUT[cin]
    packed = torch.zeros((kh, kw, cp, COUT), dtype=torch.bfloat16,
                         device=w_hwio.device)
    packed[:7, :7, :cin] = w_hwio
    return packed.reshape(kh * kw * cp, COUT)


# ------------------------------------------------------------- the kernel


def build():
    """Compile csrc/stem_conv.cu for sm_90a (once per source content, see
    cuda_build) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load('stem_conv')
    lib.stem_conv_launch.argtypes = [_P, _L, _L, _L, _L, _P, _P, _I, _I, _I,
                                     _I, _I, _P]
    lib.stem_conv_launch.restype = ctypes.c_int
    _lib = lib
    return lib


def out_shape(x):
    b, _, h, w = x.shape
    return b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, COUT


def _check(x, w_hwio, out_dtype, w_packed):
    if x.device.type != 'cuda':
        raise ValueError(f'stem_conv: unsupported device {x.device}')
    if x.dim() != 4 or x.dtype != torch.bfloat16 or x.shape[1] not in CIN:
        raise ValueError(f'stem_conv: x must be (B, Cin, H, W) bf16 with Cin '
                         f'in {CIN}, got {tuple(x.shape)} {x.dtype}')
    cin = x.shape[1]
    if (tuple(w_hwio.shape) != (7, 7, cin, COUT)
            or w_hwio.dtype != torch.bfloat16
            or w_hwio.device != x.device or not w_hwio.is_contiguous()):
        raise ValueError(f'stem_conv: w must be contiguous (7, 7, {cin}, '
                         f'{COUT}) bf16 on {x.device}, got '
                         f'{tuple(w_hwio.shape)} {w_hwio.dtype}')
    k = int(np.prod(K_LAYOUT[cin]))
    if w_packed is not None and (
            tuple(w_packed.shape) != (k, COUT)
            or w_packed.dtype != torch.bfloat16
            or w_packed.device != x.device or not w_packed.is_contiguous()
            or w_packed.data_ptr() % 16):
        raise ValueError(f'stem_conv: w_packed must be pack_weight(w), '
                         f'contiguous and 16-byte aligned ({k}, {COUT}) bf16 '
                         f'on {x.device}, got {tuple(w_packed.shape)} '
                         f'{w_packed.dtype}')
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'stem_conv: out_dtype f32 or bf16, not {out_dtype}')


def launch(x, w_packed, out):
    """One bare launch into `out` (B, OH, OW, 64) with the packed weight,
    no checks and no count."""
    b, cin, h, w = x.shape
    err = build().stem_conv_launch(
        x.data_ptr(), *x.stride(), w_packed.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.bfloat16), b, cin, h, w, cuda_stream(x))
    check_launch(_lib, err, 'stem_conv')


def stem_conv(x, w_hwio, out_dtype=torch.float32, w_packed=None):
    """x (B, Cin, H, W) bf16, w_hwio (7, 7, Cin, 64) bf16 -> (B, OH, OW, 64)
    NHWC in out_dtype: the kernel on the card (with `w_packed`, or
    pack_weight(w_hwio) made here), the plain version on the CPU."""
    if x.device.type == 'cpu':
        out = stem_conv_plain(x, w_hwio.permute(3, 2, 0, 1))
        return out.permute(0, 2, 3, 1).contiguous().to(out_dtype)
    _check(x, w_hwio, out_dtype, w_packed)
    if w_packed is None:
        w_packed = pack_weight(w_hwio)
    out = torch.empty(out_shape(x), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        launch(x, w_packed, out)
    stem_conv.launches += 1
    return out


stem_conv.launches = 0


def stem_conv_fwd(x_padded, w, side_in):
    """JAX's entry (stem_pallas.py:124): x_padded (B, Cin, Hp, Wp) bf16 from
    `pad_planar`, w (7, 7, Cin, 64) -> (B, OH, OH, 64) f32. The kernel reads
    the interior of x_padded in place; its border is the zero padding."""
    _, _, hp, wp, _ = plan(side_in)
    if tuple(x_padded.shape[2:]) != (hp, wp):
        raise ValueError(f'stem_conv_fwd: padded planar input ({hp}, {wp}) '
                         f'for side {side_in}, got {tuple(x_padded.shape)}')
    x = x_padded[:, :, 3:3 + side_in, 3:3 + side_in]
    return stem_conv(x, w.to(torch.bfloat16).contiguous(), torch.float32)


class StemConv(nn.Conv2d):
    """The 7x7/2 stem convolution, Cin -> 64, bias-free, its kernel the
    `weight` parameter (OIHW, state-dict key `<name>.weight`). A bf16
    forward that autograd does not record (the eval and serving forwards,
    the distillation teacher's) runs `stem_conv` into a bf16 NHWC tensor,
    returned as the NCHW channels_last view; any other forward (the train
    steps, f32 or f64) is F.conv2d."""

    def __init__(self, cin):
        super().__init__(cin, COUT, 7, stride=2, padding=3, bias=False)
        self._pack = None

    def forward(self, x):
        w = self.weight
        recorded = torch.is_grad_enabled() and (x.requires_grad
                                                or w.requires_grad)
        if (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
                and not recorded and x.shape[1] in CIN):
            w_hwio, w_packed = self._packed()
            return stem_conv(x, w_hwio, torch.bfloat16,
                             w_packed).permute(0, 3, 1, 2)
        return F.conv2d(x, w, stride=2, padding=3)

    def _packed(self):
        """(HWIO weight, pack_weight of it) of the weight this forward sees,
        kept for the next forward while that is the same tensor object, on
        the same memory, at the same version (every in-place update bumps
        it; writes through `.data` do not, as autograd does not see them
        either). The kept entry holds the tensor and an alias of its
        memory, so neither can be freed and its address reused while the
        entry stands: functional_call's fresh casts (the test epochs' eval
        step) are packed anew each time, a Predictor's bf16 weights once."""
        w = self.weight
        kept = self._pack
        if (kept is None or kept[0] is not w or kept[2] != w._version
                or kept[1].data_ptr() != w.data_ptr()):
            w_hwio = w.detach().permute(2, 3, 1, 0).contiguous()
            kept = (w, w.detach(), w._version, w_hwio, pack_weight(w_hwio))
            self._pack = kept
        return kept[3:]
