"""Post-training int8 quantization for the serving path (port of
pose_tpu/quant.py).

- weights: symmetric per-output-channel int8, from the serving model's
  own (serve-dtype) kernels, quantized once when the quantized model is
  built (`quantize_model`);
- activations: symmetric per-tensor int8 with scales CALIBRATED by running
  representative crops through the float forward and recording each conv
  input's absmax (`Calibrator`);
- accumulation: exact int32 sums in the hand-written int8 conv
  (`ops/int8_conv.py`), dequantized to the compute dtype before the BN and
  ReLU that follow; on the card each QuantizedConv is one call of the
  `pose_tpu_torch::quantized_conv` op, `ops/int8_conv.quantized_conv`
  (the quantize pass and the conv with the dequant in its epilogue).

JAX's two Flax method interceptors become torch idiom: calibration is a
forward pre-hook on every `nn.Conv2d` (the stems' `StemConv` included)
for the length of one forward, and the int8 forward runs a copy of the
model in which each calibrated, non-skipped conv is a `QuantizedConv`
holding its prequantized int8 weight and its scales. The float model is
left as it is, so a Predictor can quantize it again with another skip
list. Partial convolutions (`PartialConv2d`, not an `nn.Conv2d`) are never
quantized, as in JAX: their renorm is precision-sensitive.

Scales are keyed by JAX's conv paths (`conv1`, `layer2/0/conv2`,
`layer2/0/downsample_0`, `fusion_conv`, `cam_regressor`, ...;
`convert.to_jax_path`), so a scales JSON written by either package loads
in the other. A skip entry matches a path's last component.

The bits follow JAX's: sx = f32(max(absmax, 1e-12) / 127) in Python
doubles; sw = max(|w|, 1e-12) / 127 in f32 per output channel; both
quantizations divide (never multiply by a reciprocal: a CUDA division by a
Python scalar does), round half to even and clip to +-127; the dequant is
y_f32 * (sx * sw) with the f32 product taken first, then + bias, then the
cast to the input's dtype.
"""

import copy
import itertools
import json

import numpy as np
import torch
from torch import nn

from .models.convert import to_jax_path
from .ops.int8_conv import Geometry, pack_weight
from .ops.library import quantized_conv

# regressor heads (rgb dual heads + the depth/fusion family's single head)
DEFAULT_SKIP = ('cam_regressor', 'mat_regressor', 'regressor')


def conv_paths(model):
    """{JAX conv path: module} of every nn.Conv2d of `model`, in module
    order."""
    return {to_jax_path(name): mod for name, mod in model.named_modules()
            if isinstance(mod, nn.Conv2d)}


def _divide(a, b):
    """a / b with b a Python float: true division in a's dtype on a's
    device (a scalar divisor on the card becomes a reciprocal multiply)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


class Calibrator:
    """Streaming per-conv-path input-absmax calibration: feed input tuples
    with `update(batch)` as they arrive, read `scales` when done (N-batch
    running-max calibration). `apply_fn(*batch)` runs the model's inference
    forward; while it runs, every nn.Conv2d of `model` records the f32
    absmax of its input, the running max over call sites (a module applied
    twice per forward) and batches. The maxima stay on the model's device
    until `scales` reads them."""

    def __init__(self, model, apply_fn):
        self._paths = conv_paths(model)
        self._apply = apply_fn
        self._totals = {}
        self.count = 0

    def _record(self, path):
        def hook(module, args):
            cur = args[0].detach().float().abs().amax()
            prev = self._totals.get(path)
            self._totals[path] = cur if prev is None else torch.maximum(prev,
                                                                        cur)
        return hook

    def update(self, batch):
        """Fold one input tuple into the running absmax."""
        handles = [mod.register_forward_pre_hook(self._record(path))
                   for path, mod in self._paths.items()]
        try:
            with torch.inference_mode():
                self._apply(*batch)
        finally:
            for h in handles:
                h.remove()
        self.count += 1
        return self

    @property
    def scales(self):
        if not self._totals:
            raise ValueError('calibration saw no nn.Conv2d calls — is the '
                             'model a partial-conv-only variant?')
        return {path: float(v) for path, v in self._totals.items()}


def calibrate(model, apply_fn, batches):
    """Per-conv-path input absmax over calibration batches (input tuples
    for `apply_fn`, which runs `model`'s inference forward). Returns
    {conv_path: float_absmax}."""
    cal = Calibrator(model, apply_fn)
    for batch in batches:
        cal.update(batch)
    return cal.scales


def quantize_kernel(kernel):
    """Symmetric per-out-channel int8 for one OIHW kernel: returns
    `(int8_kernel, float32_scales)` with `scales` shaped (out_channels,)."""
    kf = kernel.detach().float()
    sw = _divide(torch.clamp(kf.abs().amax(dim=(1, 2, 3)), min=1e-12), 127.0)
    wq = torch.clamp(torch.round(kf / sw[:, None, None, None]), -127, 127)
    return wq.to(torch.int8), sw


def _padding(conv, path):
    """The conv's symmetric (ph, pw), refusing what the int8 body does not
    replicate: a silent mismatch would compute a different conv."""
    if conv.groups != 1:
        raise NotImplementedError(f'int8 conv: groups={conv.groups} at '
                                  f'{path!r}')
    if conv.padding_mode != 'zeros':
        raise NotImplementedError(f'int8 conv: padding_mode '
                                  f'{conv.padding_mode!r} at {path!r}')
    if conv.padding == 'valid':
        return (0, 0)
    if conv.padding == 'same':
        span = [d * (k - 1) for d, k in zip(conv.dilation, conv.kernel_size)]
        if any(s % 2 for s in span):
            raise NotImplementedError(f'int8 conv: asymmetric \'same\' '
                                      f'padding at {path!r}')
        return tuple(s // 2 for s in span)
    return tuple(conv.padding)


class QuantizedConv(nn.Module):
    """One calibrated conv of the int8 forward, one call of the
    `pose_tpu_torch::quantized_conv` op (`ops/library.py`, the wrapper
    `ops/int8_conv.quantized_conv`): quantize the input with the
    calibrated scale, the int8 conv (exact int32 sums; rounded to bf16
    when acc_dtype is bf16, JAX's `acc_dtype`), dequantize, add the bias,
    cast back to the input's dtype. The weight is quantized from the float
    conv's weight here, once, and packed for the kernel."""

    def __init__(self, conv, absmax, path, acc_dtype=torch.int32):
        super().__init__()
        if acc_dtype not in (torch.int32, torch.bfloat16):
            raise ValueError(f'acc_dtype int32 or bfloat16, not {acc_dtype}')
        self.path, self.acc_dtype = path, acc_dtype
        self.geom = Geometry(conv.out_channels, conv.in_channels,
                             tuple(conv.kernel_size), tuple(conv.stride),
                             _padding(conv, path), tuple(conv.dilation))
        wq, sw = quantize_kernel(conv.weight)
        dev = conv.weight.device
        sx = torch.tensor(np.float32(max(absmax, 1e-12) / 127.0),
                          device=dev)
        self.register_buffer('weight_packed', pack_weight(wq))
        self.register_buffer('w_scale', sw)
        self.register_buffer('x_scale', sx)
        self.register_buffer('scale', (sx * sw)[:, None, None])
        self.register_buffer('bias', None if conv.bias is None
                             else conv.bias.detach()[:, None, None])

    def forward(self, x):
        return quantized_conv(x, self.weight_packed, self.geom, self.x_scale,
                              self.scale, self.bias, self.acc_dtype)


def quantized_convs(model):
    """{JAX conv path: QuantizedConv} of a quantized model."""
    return {m.path: m for m in model.modules()
            if isinstance(m, QuantizedConv)}


def quantize_model(model, absmax, skip=DEFAULT_SKIP, acc_dtype=torch.int32):
    """The int8 serving copy of `model`: every nn.Conv2d whose path has a
    calibrated absmax and whose last path component is not in `skip`
    becomes a QuantizedConv; every other module, parameter and buffer is
    `model`'s own, shared, and `model` is left as it was."""
    shared = {id(t): t for t in itertools.chain(model.parameters(),
                                                model.buffers())}
    qmodel = copy.deepcopy(model, shared)
    names = {to_jax_path(name): name for name, mod in qmodel.named_modules()
             if isinstance(mod, nn.Conv2d)}
    for path, name in names.items():
        if path not in absmax or path.rsplit('/', 1)[-1] in skip:
            continue
        parent_name, _, attr = name.rpartition('.')
        parent = qmodel.get_submodule(parent_name)
        setattr(parent, attr, QuantizedConv(getattr(parent, attr),
                                            absmax[path], path, acc_dtype))
    return qmodel


def save_scales(path, absmax):
    with open(path, 'w') as f:
        json.dump({k: float(v) for k, v in absmax.items()}, f, indent=0,
                  sort_keys=True)


def load_scales(path):
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f).items()}
