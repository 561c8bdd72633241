"""The serving forward's two kernels as PyTorch operators, and the loader of
a deployment artifact.

`torch.export` and a CUDA-graph capture see through a call only where it is
an operator of PyTorch's dispatcher with a shape function; the kernel
wrappers are ctypes calls. So both are registered here with
`torch.library.custom_op`, each with a fake (meta) function that gives the
real op's shape, dtype and strides:

- `pose_tpu_torch::stem_conv(x, w_hwio, w_packed, out_dtype)` — the 7x7/2
  stem, `ops/stem.stem_conv` (the hand-written kernel on the card, the
  plain version on the CPU): x (B, Cin, H, W) bf16 -> (B, 64, OH, OW) in
  out_dtype, the NCHW channels_last view of the kernel's NHWC output;
- `pose_tpu_torch::quantized_conv(x, w_packed, geom, x_scale, scale, bias,
  acc_bf16)` — one QuantizedConv, `ops/int8_conv.quantized_conv` (the
  quantize pass and the int8 conv on the card, the plain chain on the
  CPU): `geom` is `Geometry` as ten ints (`geometry_ints`), `acc_bf16`
  the bf16 accumulator; -> (B, Cout, OH, OW) in x's dtype, channels_last.
  `quantized_conv` calls it with the wrapper's own arguments;
- `load_artifact(path)` — a `.pt2` file of
  `serve.Predictor.export_artifact` as a callable
  `fn(*inputs) -> {'relat_cam', ...}`.

`stem_conv_op` and `quantized_conv_op` are the two ops. Both call their
wrapper through its module, so its launch counters count as before. This
module imports torch and the two kernel modules only, never the model
code, `serve` or `quant`: a process that imports it can load and run an
artifact. Importing it compiles nothing and needs no GPU.
"""

from typing import Optional, Sequence

import torch

from . import int8_conv, stem


@torch.library.custom_op('pose_tpu_torch::stem_conv', mutates_args=())
def _stem_conv(x: torch.Tensor, w_hwio: torch.Tensor,
               w_packed: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    return stem.stem_conv(x, w_hwio, out_dtype, w_packed).permute(0, 3, 1, 2)


@_stem_conv.register_fake
def _stem_conv_fake(x, w_hwio, w_packed, out_dtype):
    b, _, h, w = x.shape
    return x.new_empty((b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, stem.COUT),
                       dtype=out_dtype).permute(0, 3, 1, 2)


def geometry_ints(geom):
    """A Geometry as the op's ten ints: Cout, Cin, then the kernel size,
    stride, padding and dilation per axis."""
    return [geom.cout, geom.cin, *geom.kernel, *geom.stride, *geom.padding,
            *geom.dilation]


def _geometry(ints):
    cout, cin, kh, kw, sh, sw, ph, pw, dh, dw = ints
    return int8_conv.Geometry(cout, cin, (kh, kw), (sh, sw), (ph, pw),
                              (dh, dw))


@torch.library.custom_op('pose_tpu_torch::quantized_conv', mutates_args=())
def _quantized_conv(x: torch.Tensor, w_packed: torch.Tensor,
                    geom: Sequence[int], x_scale: torch.Tensor,
                    scale: torch.Tensor, bias: Optional[torch.Tensor],
                    acc_bf16: bool) -> torch.Tensor:
    return int8_conv.quantized_conv(
        x, w_packed, _geometry(geom), x_scale, scale, bias,
        torch.bfloat16 if acc_bf16 else torch.int32)


@_quantized_conv.register_fake
def _quantized_conv_fake(x, w_packed, geom, x_scale, scale, bias, acc_bf16):
    g = _geometry(geom)
    oh, ow = g.out_hw(x.shape[2], x.shape[3])
    return x.new_empty((x.shape[0], oh, ow, g.cout)).permute(0, 3, 1, 2)


stem_conv_op = torch.ops.pose_tpu_torch.stem_conv.default
quantized_conv_op = torch.ops.pose_tpu_torch.quantized_conv.default


def quantized_conv(x, w_packed, geom, x_scale, scale, bias, acc_dtype):
    """`int8_conv.quantized_conv`'s arguments (a Geometry, an acc_dtype)
    through the op: what QuantizedConv calls."""
    return quantized_conv_op(x, w_packed, geometry_ints(geom), x_scale,
                             scale, bias, acc_dtype == torch.bfloat16)


def load_artifact(path):
    """Load a `serve.Predictor.export_artifact` file: a callable
    `fn(*inputs) -> {'relat_cam', ...}` on the device it was exported on,
    at its baked batch size, needing no model code."""
    return torch.export.load(path).module()
