"""pose_tpu_torch — the PyTorch/CUDA port of pose_tpu.

The JAX package `pose_tpu/` is the reference and stays as it is; this
package mirrors its module layout and names so each module's counterpart is
easy to find (`pose_tpu/ops/warp.py` -> `pose_tpu_torch/ops/warp.py`, ...).
It imports torch, never jax, flax or anything of `pose_tpu`.

Ported so far:
- the serving path: uint8 full frames + crop homographies -> split warp
  (hand-written CUDA kernel, `csrc/split_warp.cu`) -> clip -> ImageNet
  normalise -> PoseResNet rgb with dual heads -> 3D/2D soft-argmax ->
  least-squares root, served through `serve.Predictor` and
  `serve.BatchingServer`;
- the training step: the same crops + the bbox-mask channel -> PoseResNet
  in train mode, with fused BatchNorm (four hand-written CUDA kernels,
  forward and backward, `csrc/fused_bn.cu`) under bn_impl='pallas' ->
  masked SmoothL1 on the 3D, 2D and root-reconstruction outputs ->
  clip-by-global-norm, weight decay, Adam; driven by
  `train.engine.RgbTrainer`;
- the depth, fusion and distillation stack: every PoseResNet variant,
  the depth stream's warps (the split kernel at one channel in f32; the
  two-kernel split warp whose stage B is the banded kernel,
  `csrc/banded_warp.cu`, beside its full-scanline oracle), the partial
  convolution (its renorm pair in `csrc/partial_conv.cu`), and the
  vanilla, fusion and distillation steps, driven by
  `train.depth_engine.DepthTrainer`;
- the RGB entry point `main` (`python -m pose_tpu_torch.main` with the
  root main.py's flags, parsed by `opts`): `-pretrain` through
  `models.convert.load_pretrained`, `data.loader.PoseLoader` over a
  sample store (`data.samples`, `data.crop`, `geometry`; PIL decode on
  worker threads; `data.synthetic.make_cmu_fixture` writes a seeded
  store), train and test epochs (`RgbTrainer.test`, `metrics`), the
  checkpoints and record of `train.logger.Logger`, `-val_only` /
  `-test_only` / `-resume`. The model's stem convolution runs as a
  hand-written CUDA kernel (`csrc/stem_conv.cu`, `ops.stem`) in every
  bf16 forward that autograd does not record: the test epochs under
  -half_acc, serving, the distillation teacher;
- the depth entry point `depth_main` (`python -m pose_tpu_torch.depth_main`
  with the root depth_main.py's flags): the fusion and depth teachers,
  -do_teach distillation, -semi_teach, -partial_conv, -depth_only,
  -depth_host, -save_last, -val_only / -test_only / -resume, over
  `data.loader.DepthPoseLoader` (colour and depth crops with one
  flip/zoom draw; `data.synthetic.make_ntu_fixture` and
  `make_pku_fixture` write seeded stores) and `DepthTrainer.test`. Both
  loaders decode through the native C++ pool (`data.native_loader`, this
  package's own build of native/pose_loader.cc) where the host can build
  it, and with PIL otherwise;
- the run's full state and the trace, in both entry points: `-save_state`
  and `-save_every` (`train.state_io`, `train.engine.MidEpochSaver`, the
  loaders' `start_batch` fast-forward; a resumed run equals the
  uninterrupted one bit for bit) and `-trace_dir` (`utils.profiling`);
- the compiled serving forward and deployment artifacts: on the card
  `serve.Predictor.aot_compile` captures the forward in one CUDA graph,
  which predict_crops and `serve.BatchingServer` replay;
  `Predictor.export_artifact` writes a `torch.export` program (`.pt2`)
  that `serve.ArtifactPredictor` and the predict CLI serve with only
  `ops.library` imported (the stem and int8 kernels as `torch.library`
  ops).

Entry points run on `cuda` unless the caller passes `device='cpu'`; without
a GPU and without an explicit device they raise (`runtime.resolve_device`).
"""

__version__ = "0.1.0"
