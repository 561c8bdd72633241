"""Inference/serving API (port of pose_tpu/serve.py).

    predictor = Predictor.from_checkpoint('model_20.pth', args)
    coords = predictor.predict_crops(crops)                # (B, J, 3) mm
    absolute = predictor.predict_absolute(crops, intrinsics)

    predictor.export_artifact('pose.pt2')                 # deployment file
    served = ArtifactPredictor('pose.pt2')                 # no model code

Same public surface and output dicts as JAX, for every model variant
(rgb, depth, fusion, partial_depth, partial_fusion); inputs are NHWC
crops, as there, two streams (colour, depth) for the fusion variants. The
forward runs at a fixed batch size (ragged batches are edge-padded):
eagerly, or, once `aot_compile` ran on the card, as one CUDA graph of the
whole forward and decode (`CapturedForward`, the counterpart of JAX's AOT
executable; on the CPU `aot_compile` is a warm-up). Under -half_acc the
parameters are bf16 and BN statistics f32, the JAX `_cast_floats`
semantics (serve.py:160-195), and head features are cast to f32 before the
softmax. `quantize` / `quantize_with_scales` switch the forward to int8
convolutions (`quant.py`, the hand-written int8 conv on the card).
`export_artifact` writes the forward with its weights and decode as a
`torch.export` program (`.pt2`); `load_artifact` and `ArtifactPredictor`
serve it with only `ops/library.py`'s ops registered. Device meshes are
not ported yet (ROADMAP Queue 1 item 4)."""

import queue as queue_lib
import threading
import time
import types
from concurrent.futures import Future

import numpy as np
import torch
from torch import nn

from . import quant, runtime
from .data import augment
from .models import build_model, init_weights
from .models.convert import complete_state, load_torch_file
from .ops import heatmap, int8_conv, library, recon, warp

# forwards a capture runs first on a side stream: cuDNN's algorithm choice,
# the kernels' one-time set-up (their shared-memory attributes, the int8
# plans) and lazy module loading happen there, not in the capture
CAPTURE_WARMUP = 2


def default_args(**over):
    base = dict(model='resnet50', criterion='SmoothL1', half_acc=True,
                extra_channel=False, joint_space=True, skip_relu=False,
                early_dist=False, depth_only=False,
                side_in=257, stride=16, num_joints=19, depth=16,
                depth_range=1000.0)
    base.update(over)
    return types.SimpleNamespace(**base)


def _edge_pad(inputs, target):
    """Edge-pad every tensor's leading dim up to `target` by repeating the
    last row (the pad rows are sliced off by the caller). No-op when already
    >= target."""
    b = inputs[0].shape[0]
    if b >= target:
        return inputs
    return tuple(torch.cat([x, x[-1:].expand(target - b, *x.shape[1:])])
                 for x in inputs)


class CapturedForward:
    """One CUDA graph of a fixed-shape forward `fn(*inputs) -> {name:
    tensor}` on the card, the counterpart of JAX's AOT executable:
    captured once at the shapes and dtypes of `sample_inputs`, after
    CAPTURE_WARMUP forwards on a side stream, into static input and output
    tensors. A call copies its inputs in, replays the graph and returns
    clones of the outputs, holding a lock across the three, so threads
    may share it; a call on another stream waits for the last replay's
    end. The int8 convs' input scratch is the graph's own
    (`int8_conv.graph_scratch`). A failed capture raises."""

    def __init__(self, fn, sample_inputs):
        self.device = sample_inputs[0].device
        self.inputs = tuple(x.clone() for x in sample_inputs)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                fn(*self.inputs)
        current.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with int8_conv.graph_scratch() as self._scratch, \
                torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()

    def matches(self, inputs):
        """Whether `inputs` have the captured shapes, dtypes and device."""
        return len(inputs) == len(self.inputs) and all(
            x.shape == s.shape and x.dtype == s.dtype and x.device == s.device
            for x, s in zip(inputs, self.inputs))

    def __call__(self, inputs):
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._done)
            for static, x in zip(self.inputs, inputs):
                static.copy_(x)
            self.graph.replay()
            out = {k: v.clone() for k, v in self.outputs.items()}
            self._done.record(stream)
        return out


class _ServingForward(nn.Module):
    """A Predictor's serving forward (input cast, model, decode) as a
    module for torch.export: its serving model (the float one or the int8
    copy) is a submodule, so its weights are the program's."""

    def __init__(self, predictor):
        super().__init__()
        self.model = predictor._serving_model()
        self._forward = predictor._forward_impl

    def forward(self, *inputs):
        return self._forward(*inputs)


class _FixedBatch:
    """The serving surface Predictor and ArtifactPredictor share: a
    forward at one batch size (`_forward_impl`, inputs placed and padded by
    `_place_inputs`), run eagerly or, after aot_compile on the card, as a
    CapturedForward. Subclasses set `device`, `batch_size`,
    `_sample_inputs(b)` and call `_init_serving()`."""

    def _init_serving(self):
        self._warm = False
        self._graph = None                   # aot_compile's CapturedForward
        # aot_compile's capture against a swap of the forward
        self._lock = threading.Lock()

    @torch.inference_mode()
    def _run(self, inputs):
        """One forward on placed inputs: the captured graph when
        aot_compile made one and the inputs have its shapes (JAX's `_run`,
        serve.py:197), else the eager forward."""
        graph = self._graph
        if graph is not None and graph.matches(inputs):
            return graph(inputs)
        return self._forward_impl(*inputs)

    def predict_crops(self, *inputs):
        """Root-relative 3D (and 2D when joint_space) for prepared NHWC
        crops; numpy outputs, batch padding removed."""
        inputs, b = self._place_inputs(inputs)
        out = self._run(inputs)
        return {k: v[:b].cpu().numpy() for k, v in out.items()}

    def warm_up(self):
        """One forward at the configured batch size, waited for. cuDNN
        algorithm choice, lazy module loading and the calling thread's
        cuDNN and cuBLAS handles happen here, not on the first request; a
        thread that runs forwards warms up in that thread."""
        self._run(self._sample_inputs(self.batch_size))
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def aot_compile(self):
        """On the card: capture the forward at batch_size in one CUDA graph
        (`CapturedForward`), which predict_crops, predict_absolute and
        BatchingServer then replay for every batch_size-shaped (or padded
        ragged) batch; a failed capture raises. On the CPU: the warm-up of
        the calling thread (`warm_up`). Idempotent; returns the forward
        (`_run`)."""
        with self._lock:
            if self.device.type != 'cuda':
                if not self._warm:
                    self.warm_up()
                    self._warm = True
            elif self._graph is None:
                with torch.inference_mode():
                    self._graph = CapturedForward(
                        self._forward_impl,
                        self._sample_inputs(self.batch_size))
        return self._run


class Predictor(_FixedBatch):
    """Fixed-batch pose predictor for one model variant on one device.

    state_dict: a port/reference-keyed state_dict (convert.py), loaded with
    strict=True; None initialises the weights from `seed`
    (models.init_weights)."""

    def __init__(self, args, variant='rgb', state_dict=None, batch_size=8,
                 device=None, seed=0):
        self.args = args
        self.variant = variant
        self.batch_size = batch_size
        self.device = runtime.resolve_device(device)
        self.dtype = runtime.serve_dtype(args.half_acc)
        model = build_model(args, variant)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(complete_state(state_dict), strict=True)
        # channels_last: NHWC crops (the JAX layout) permute into it for
        # free, cuDNN's bf16 convolutions run NHWC, and every batch reaches
        # the convolutions in one memory format, so one algorithm serves
        # them all and a request's answer does not depend on how its batch
        # was assembled
        model.eval().to(self.device, memory_format=torch.channels_last)
        for p in model.parameters():
            p.requires_grad_(False)
            p.data = p.data.to(self.dtype)   # BN running stats stay f32
        self.model = model                   # the float model, always
        self._quant_scales = None            # set by quantize_with_scales
        self._quant_model = None             # the int8 serving copy
        self._init_serving()

    @classmethod
    def from_checkpoint(cls, path, args, variant='rgb', batch_size=8,
                        device=None):
        """Load a model_<E>.pth (ours, pose_tpu's or the reference's)."""
        blob = load_torch_file(path)
        state = (blob['model'] if isinstance(blob, dict) and 'model' in blob
                 else blob)
        return cls(args, variant, state, batch_size, device)

    def _sample_inputs(self, b):
        s = self.args.side_in

        def ones(ch):
            return torch.ones((b, s, s, ch), device=self.device)

        if self.variant in ('fusion', 'partial_fusion'):
            return (ones(3), ones(1))
        in_ch = 1 if getattr(self.args, 'depth_only', False) else 3
        if self.variant == 'rgb' and getattr(self.args, 'extra_channel',
                                             False):
            in_ch = 4
        return (ones(in_ch),)

    def _on_device(self, inputs):
        return tuple(torch.as_tensor(x).to(self.device) for x in inputs)

    def _place_inputs(self, inputs):
        """Inputs on the predictor's device, the leading dim edge-padded up
        to batch_size. Returns (inputs, real_batch)."""
        inputs = self._on_device(inputs)
        b = inputs[0].shape[0]
        return _edge_pad(inputs, self.batch_size), b

    def _model_inputs(self, inputs):
        """NHWC streams -> the model's NCHW channels_last inputs in the
        serve dtype (one dtype policy for serving and calibration)."""
        return [x.permute(0, 3, 1, 2).to(self.dtype).contiguous(
            memory_format=torch.channels_last) for x in inputs]

    def _serving_model(self):
        return (self._quant_model if self._quant_model is not None
                else self.model)

    def _forward_impl(self, *inputs):
        out = self._serving_model()(*self._model_inputs(inputs))
        if self.variant == 'rgb' and self.args.joint_space:
            cam_feat, mat_feat = out
        elif self.variant == 'rgb':
            cam_feat, mat_feat = out, None
        else:                       # depth family: (cam, tap)
            cam_feat, mat_feat = out[0], None
        hm = heatmap.to_heatmap3d(cam_feat.float(), self.args.depth,
                                  self.args.num_joints)
        relat = heatmap.decode3d(hm, self.args.depth_range)
        relat = relat - relat[:, :1]       # root set by caller's key_index
        result = {'relat_cam': relat}
        if mat_feat is not None:
            hm2 = heatmap.to_heatmap2d(mat_feat.float(), self.args.num_joints)
            result['spec_mat'] = heatmap.decode2d(hm2, self.args.side_in)
        return result

    def predict_absolute(self, crops, intrinsics, key_index=0):
        """Absolute camera-space joints through the least-squares root
        (requires joint_space; utils.get_deter_cam semantics)."""
        inputs, b = self._place_inputs((crops,))
        out = self._run(inputs)
        if 'spec_mat' not in out:
            raise ValueError('predict_absolute requires a joint_space model')
        relat = out['relat_cam'][:b]
        relat = relat - relat[:, key_index:key_index + 1]
        intrinsics = torch.as_tensor(intrinsics).to(self.device,
                                                    torch.float32)
        with torch.inference_mode():
            absolute = recon.recon_root(out['spec_mat'][:b], relat,
                                        intrinsics)
        return absolute.cpu().numpy()

    def make_calibrator(self):
        """Streaming N-batch calibration (quant.Calibrator) of the float
        model: feed request batches as they arrive with `cal.update(inputs)`
        (inputs in `predict_crops` form), then switch to int8 once with
        `quantize_with_scales(cal.scales)`. The calibration forward casts as
        the serving forward does, so each conv records what it serves."""
        return quant.Calibrator(self.model, lambda *ins: self.model(
            *self._model_inputs(self._on_device(ins))))

    def quantize(self, calib_batches, skip=quant.DEFAULT_SKIP,
                 acc_dtype=torch.int32):
        """Switch the serving forward to int8 convs (quant.py), with
        activation scales calibrated from `calib_batches`, an iterable of
        input tuples of the form `predict_crops` takes (single-input
        variants may pass bare arrays). Regressor heads keep the serve
        dtype by default (`skip`). Returns the calibrated
        {conv_path: absmax}, for quant.save_scales and
        `quantize_with_scales`."""
        cal = self.make_calibrator()
        for b in calib_batches:
            cal.update(b if isinstance(b, (tuple, list)) else (b,))
        self.quantize_with_scales(cal.scales, skip, acc_dtype)
        return cal.scales

    def quantize_with_scales(self, scales, skip=quant.DEFAULT_SKIP,
                             acc_dtype=torch.int32):
        """Apply previously calibrated activation scales (see quantize):
        the weights are quantized once, here, into the int8 serving copy
        (`quant.quantize_model`); `self.model` keeps the float model, so
        this may run again with another skip list. The graph of an earlier
        aot_compile is dropped, as JAX drops its stale AOT executable
        (serve.py:280-281): the next aot_compile captures the int8
        forward."""
        with self._lock:
            self._quant_scales = dict(scales)
            self._quant_model = quant.quantize_model(
                self.model, self._quant_scales, tuple(skip), acc_dtype)
            self._warm = False
            self._graph = None
        return self

    def export_artifact(self, path):
        """Write the whole predict graph at batch_size (input cast, the
        serving model with its weights, float or int8, and the decode) as a
        self-contained `torch.export` program (`.pt2`); it loads with
        `load_artifact` or `ArtifactPredictor` without the model code and
        runs on this Predictor's device. Its outputs are predict_crops'
        dict. Returns path."""
        inputs, _ = self._place_inputs(self._sample_inputs(self.batch_size))
        with self._lock, torch.no_grad():
            program = torch.export.export(_ServingForward(self), inputs,
                                          strict=False)
        torch.export.save(program, path)
        return path

    load_artifact = staticmethod(library.load_artifact)


class ArtifactPredictor(_FixedBatch):
    """Predictor surface over an `export_artifact` file (JAX's
    ArtifactPredictor, serve.py:329-410): `batch_size`, `in_shapes` and
    `out_shapes` are read back from the program, `predict_crops`,
    `warm_up`, `_place_inputs`, `_run` and `aot_compile` (a CUDA graph of
    the loaded program on the card) are the Predictor's, so
    BatchingServer and the predict CLI serve the file with no model code
    or checkpoint. The weights live in the program (`variables` and
    `serve_variables` are None). The artifact runs on the device it was
    exported on; asking for another raises."""

    def __init__(self, path, device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                'ArtifactPredictor(mesh=...): data-parallel serving is not '
                'ported yet (ROADMAP Queue 1 item 4)')
        self.device = runtime.resolve_device(device)
        program = torch.export.load(path)
        vals = {n.name: n.meta.get('val') for n in program.graph.nodes}
        sig = program.graph_signature
        ins = [vals[name] for name in sig.user_inputs]
        exported_on = ins[0].device
        if (exported_on.type != self.device.type
                or (exported_on.index is not None
                    and self.device.index is not None
                    and exported_on.index != self.device.index)):
            raise ValueError(f'artifact {path} was exported on '
                             f'{exported_on} and runs there only, not on '
                             f'{self.device}')
        self.in_shapes = tuple(tuple(x.shape) for x in ins)
        self.out_shapes = tuple(tuple(vals[name].shape)
                                for name in sig.user_outputs)
        self._in_dtypes = tuple(x.dtype for x in ins)
        self.batch_size = self.in_shapes[0][0]
        self.variables = None                # weights live in the artifact
        self.serve_variables = None
        self._call = program.module()
        self._init_serving()

    def _sample_inputs(self, b):
        return tuple(torch.ones((b,) + s[1:], dtype=d, device=self.device)
                     for s, d in zip(self.in_shapes, self._in_dtypes))

    def _place_inputs(self, inputs):
        """Inputs on the device, edge-padded up to the artifact's baked
        batch size (the program has exactly one shape); a larger batch
        raises. Returns (inputs, real_batch)."""
        inputs = tuple(torch.as_tensor(x).to(self.device) for x in inputs)
        b = inputs[0].shape[0]
        if b > self.batch_size:
            raise ValueError(
                f'batch of {b} rows exceeds the artifact\'s baked batch '
                f'size {self.batch_size} — chunk requests (or re-export '
                'with a larger batch_size)')
        return _edge_pad(inputs, self.batch_size), b

    def _forward_impl(self, *inputs):
        return self._call(*inputs)


class BatchingServer:
    """Request micro-batching in front of a Predictor or ArtifactPredictor
    (serve.py:411): single-crop requests are batched up to the predictor's
    batch size (or until `max_delay_ms` passes), padded to the fixed shape,
    run through one forward (the CUDA graph of `aot_compile` on the card),
    and resolved through per-request futures.

        server = BatchingServer(predictor, max_delay_ms=5.0)
        fut = server.submit(crop)              # (side_in, side_in, C)
        coords = fut.result()['relat_cam']     # (J, 3)
        server.stop()
    """

    def __init__(self, predictor, max_delay_ms=5.0, queue_size=1024):
        self.predictor = predictor
        self.batch_size = predictor.batch_size
        self.max_delay = max_delay_ms / 1000.0
        self._queue = queue_lib.Queue(maxsize=queue_size)
        self._stopping = False
        # guards the (check _stopping, enqueue) pair of submit() against
        # stop(), so no request lands behind the stop sentinel unresolved
        self._lock = threading.Lock()
        self.served = 0
        self.batches = 0
        # the worker runs the predictor's aot_compile (the capture on the
        # card, the warm-up on the CPU) in its own thread before it takes
        # requests (cuDNN and cuBLAS handles are per thread); the server is
        # returned ready, or the error is raised here
        self._ready = threading.Event()
        self._warm_error = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._warm_error is not None:
            self._thread.join()
            raise self._warm_error

    def submit(self, crop):
        """Enqueue one crop (numpy array or tensor); returns a Future
        resolving to the predictor's output dict without the batch dim."""
        item = (crop, Future())
        with self._lock:
            if self._stopping:
                raise RuntimeError('server is stopped')
            self._queue.put(item)
        return item[1]

    def predict(self, crop, timeout=None):
        """Blocking single-request convenience wrapper."""
        return self.submit(crop).result(timeout)

    def stop(self):
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            self._queue.put(None)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def _collect(self):
        """Block for the first request, then drain up to batch_size-1 more
        within the latency budget."""
        item = self._queue.get()
        if item is None:
            return None
        items = [item]
        deadline = time.monotonic() + self.max_delay
        while len(items) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue_lib.Empty:
                break
            if nxt is None:
                self._queue.put(None)   # re-post the sentinel for next round
                break
            items.append(nxt)
        return items

    def _worker(self):
        device = self.predictor.device
        try:
            self.predictor.aot_compile()
        except Exception as e:
            self._warm_error = e
            return
        finally:
            self._ready.set()
        while True:
            items = self._collect()
            if items is None:
                return
            try:
                # assembly is inside the try: a malformed request resolves
                # its batch's futures with the error instead of killing the
                # worker and wedging every later submit()
                crops = torch.stack([torch.as_tensor(c).to(device)
                                     for c, _ in items])
                # a live quantize_with_scales drops the float graph: the
                # next batch captures the int8 forward here (idempotent
                # otherwise)
                self.predictor.aot_compile()
                batch, _ = self.predictor._place_inputs((crops,))
                out = self.predictor._run(batch)
                host = {k: v.cpu().numpy() for k, v in out.items()}
                for i, (_, fut) in enumerate(items):
                    fut.set_result({k: a[i] for k, a in host.items()})
            except Exception as e:               # resolve, don't wedge
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
            self.served += len(items)
            self.batches += 1


def _frames_on(device, frames, homographies, extents):
    return (torch.as_tensor(frames).to(device),
            torch.as_tensor(homographies).to(device, torch.float32),
            torch.as_tensor(extents).to(device, torch.int32))


def preprocess_frames(frames, homographies, extents, side_in, device=None):
    """Full frames -> normalised network-input crops on the device, no
    augmentation (serve.py:536): the exact mxu warp, as in JAX."""
    device = runtime.resolve_device(device)
    return augment.process_color_batch(
        *_frames_on(device, frames, homographies, extents), None, side_in,
        False, False, warp_impl='mxu')


class GatedPreprocessor:
    """preprocess_frames through the split warp with the loader's per-batch
    gate (data/loader.py:338-357): a batch whose host homographies pass
    `warp.split_band_ok` runs 'split' (the CUDA kernel), any other batch the
    exact 'mxu' warp — there the banded TPU kernel would drop weight. Both
    choices are counted (`split_batches`, `mxu_batches`) so a caller can
    report them."""

    def __init__(self, side_in, device=None):
        self.side_in = side_in
        self.device = runtime.resolve_device(device)
        self.split_batches = 0
        self.mxu_batches = 0

    def __call__(self, frames, homographies, extents):
        homs = np.asarray(homographies, np.float32)
        if warp.split_band_ok(homs, (self.side_in, self.side_in)):
            impl = 'split'
            self.split_batches += 1
        else:
            impl = 'mxu'
            self.mxu_batches += 1
        return augment.process_color_batch(
            *_frames_on(self.device, frames, homs, extents), None,
            self.side_in, False, False, warp_impl=impl)
