"""Inference CLI of the port (the counterpart of the root predict.py): run a
trained pose checkpoint on images or a video, with the same flags.

    python -m pose_tpu_torch.predict -model resnet50 \\
        -model_path save/.../model_20.pth -joint_space \\
        -images 'frames/*.jpg' -bboxes boxes.json -camera camera.json \\
        -out poses.json -viz overlays/

The path: host crop cameras (`data/crop.build_crop`, the reference's
datasets.py:78-121 sequence) -> the exact mxu colour warp on the device
(`data/augment.process_color_batch`, warp_impl='mxu'), or the general
lookup for distorted cameras, or `process_depth_batch` for the depth
stream -> `serve.Predictor` (every variant; `-quantize`: int8 convs on
the hand-written int8 kernel) -> decode -> for joint-space models the
least-squares absolute root (`ops/recon.py`). Outputs are JSON
(root-relative mm in the original camera frame; absolute camera/world mm
and full-frame 2D px when the model has the 2D head) plus optional
skeleton-overlay PNGs (`tools/viz.py`, matplotlib).

The depth model families deploy too: `-depth_only -depth_images ...` for
the distilled depth student, `-do_fusion` with both streams,
`-partial_conv` for the mask-propagating trunks; `-nexponent`,
`-to_depth` and `-depth_thresh` must match the training flags.

A `.pt2` -model_path (`serve.Predictor.export_artifact`) serves through
`serve.ArtifactPredictor` at the artifact's baked batch size and
precision, after JAX's checks of its shapes against the flags; a JAX
`.jaxexport` file is refused (it needs JAX).

Device: CUDA unless the caller passes one (`main(argv, device='cpu')`, as
the tests do); without a GPU and without a device it raises. `-mesh` above
1 is not ported yet and raises NotImplementedError naming its ROADMAP
item.
"""

import argparse
import glob
import json
import os
import sys

import numpy as np
import torch

from . import runtime, serve
from .data import augment, crop, joints
from .data.loader import condition_image, imread
from .geometry import camera as cameralib
from .models.convert import load_torch_file
from .ops import recon

# deployment artifacts: the port's torch.export file, which it serves, and
# JAX's jax.export file, which it refuses
ARTIFACT_SUFFIX, JAX_ARTIFACT_SUFFIX = '.pt2', '.jaxexport'


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-model', default='resnet50',
                        choices=['resnet18', 'resnet50'])
    parser.add_argument('-model_path', required=True,
                        help='model_<E>.pth checkpoint (ours, pose_tpu\'s or '
                             'reference-converted), or best.pth beside it, '
                             'or a .pt2 deployment artifact '
                             '(Predictor.export_artifact)')
    # model-shape flags; must match the checkpoint (opts.py defaults)
    parser.add_argument('-side_in', default=257, type=int)
    parser.add_argument('-stride', default=16, type=int)
    parser.add_argument('-num_joints', default=19, type=int)
    parser.add_argument('-depth', default=16, type=int)
    parser.add_argument('-depth_range', default=1000.0, type=float)
    parser.add_argument('-joint_space', action='store_true')
    parser.add_argument('-extra_channel', action='store_true')
    parser.add_argument('-half_acc', action='store_true',
                        help='bfloat16 forward (matches -half_acc training)')
    # depth-family model dispatch (depth_main.py:37-42 semantics)
    parser.add_argument('-depth_only', action='store_true',
                        help='1-channel depth-input model (the distilled '
                             'student)')
    parser.add_argument('-do_fusion', action='store_true',
                        help='fusion model: RGB + depth streams')
    parser.add_argument('-partial_conv', action='store_true',
                        help='partial-conv (mask-propagating) depth trunk')
    parser.add_argument('-depth_net', action='store_true',
                        help='3-channel depthnet trunk fed with RGB (the '
                             'reference depth model without -depth_only)')
    parser.add_argument('-nexponent', action='store_true',
                        help='exp(-d) depth enhancement (must match '
                             'training)')
    parser.add_argument('-to_depth', action='store_true',
                        help='ray-length -> z-depth correction (must match '
                             'training)')
    parser.add_argument('-depth_thresh', default=0.1, type=float,
                        help='depth validity threshold: 0.1 (NTU-style) or '
                             '0.5 (PKU-style), in the enhanced scale')
    # inputs
    parser.add_argument('-images', help="glob of image files (sorted)")
    parser.add_argument('-video', help='video file (all frames; needs cv2)')
    parser.add_argument('-depth_images',
                        help='glob of 16-bit depth PNGs (sorted; raw '
                             'uint16 / 65535)')
    parser.add_argument('-depth_bboxes',
                        help='JSON person boxes in the depth view (same '
                             'forms as -bboxes); default = full frame')
    parser.add_argument('-depth_camera',
                        help='JSON with K for the depth camera (pinhole '
                             'only); default = centered pinhole guess')
    parser.add_argument('-bboxes',
                        help='JSON person boxes [x, y, w, h]: a dict keyed '
                             'by frame key, a per-frame list, or one box '
                             'for every frame; a per-frame entry may be a '
                             'LIST of boxes (one output record per person); '
                             'default = full frame')
    parser.add_argument('-camera',
                        help='JSON with K (3x3) and optional R (3x3), '
                             't (3, extrinsic translation), dist, world_up; '
                             'default = centered pinhole with -focal')
    parser.add_argument('-focal', default=0.0, type=float,
                        help='focal length for the default camera '
                             '(0 = 1.2 * max(height, width))')
    parser.add_argument('-skeleton', default='cmu',
                        choices=['cmu', 'h36m', 'ntu'],
                        help='skeleton tables for the root joint and viz '
                             'edges')
    parser.add_argument('-quantize', action='store_true',
                        help='serve with int8 convolutions (the int8 conv '
                             'kernel on the card), activation scales '
                             'calibrated on the first batch (quant.py); '
                             'regressor heads keep the serve dtype')
    parser.add_argument('-calib_batches', default=1, type=int,
                        help='with -quantize: calibrate activation scales '
                             'over the first N request batches (running '
                             'absmax); batches 1..N-1 serve at full '
                             'precision, int8 starts WITH batch N (which '
                             'also calibrates). For -video streams shorter '
                             'than N, nothing quantizes (a warning is '
                             'printed)')
    parser.add_argument('-track_ids', action='store_true',
                        help='assign stable per-person track ids across '
                             'frames (tools/tracking.py)')
    # outputs
    parser.add_argument('-out', default='predictions.json')
    parser.add_argument('-viz', help='directory for overlay PNGs (needs '
                                     'matplotlib)')
    parser.add_argument('-batch_size', default=8, type=int)
    parser.add_argument('-mesh', default=0, type=int,
                        help='data-parallel serving over N devices (not '
                             'ported yet)')
    return parser


def check_ported(args):
    """Raise NotImplementedError for a flag whose part is not ported."""
    if args.mesh > 1:
        raise NotImplementedError('-mesh: data-parallel serving is not '
                                  'ported yet (ROADMAP Queue 1 item 4)')


def _require(module, flag):
    """Import an optional dependency at first use, or say which flag needs
    it."""
    try:
        return __import__(module)
    except ImportError as e:
        raise SystemExit(f'{flag} needs {module}, which is not installed: '
                         f'{e}')


def load_frames(args):
    """Ordered colour frames from -images (eager list) or -video (LAZY
    generator: the chunk loop consumes batch_size frames at a time).

    Returns (frames, count, canvas_hw): for -video the count and canvas
    are None until streaming starts (video frames share one size, so the
    first frame fixes the canvas)."""
    if (args.images is None) == (args.video is None):
        raise SystemExit('pass exactly one of -images / -video')
    if args.video:
        _require('cv2', '-video')
        from .tools.video import prefetch

        def stream():
            for i, frame in enumerate(prefetch(args.video)):
                yield ('frame_%06d' % i, frame)
        return stream(), None, None

    paths = sorted(glob.glob(args.images))
    if not paths:
        raise SystemExit(f'no files match {args.images!r}')
    frames = [(os.path.basename(path), condition_image(imread(path)))
              for path in paths]
    canvas_hw = (max(f.shape[0] for _, f in frames),
                 max(f.shape[1] for _, f in frames))
    return frames, len(frames), canvas_hw


def chunks_of(frames, bs):
    """Batch an iterable of frames into lists of exactly bs (the tail chunk
    padded by repeating its last frame) plus the real count."""
    buf = []
    for item in frames:
        buf.append(item)
        if len(buf) == bs:
            yield buf, bs
            buf = []
    if buf:
        n = len(buf)
        while len(buf) < bs:
            buf.append(buf[-1])
        yield buf, n


def _as_boxes(spec):
    """The spec as a float array, or None where ragged person counts defeat
    asarray."""
    try:
        return np.asarray(spec, np.float32)
    except ValueError:
        return None


def _frame_boxes(key, image, idx, spec, flag):
    """Boxes for ONE frame: the spec's per-frame value is a single
    [x, y, w, h] or a LIST of them (multi-person)."""
    if spec is None:
        val = [[0, 0, image.shape[1], image.shape[0]]]
    elif isinstance(spec, dict):
        if key not in spec:
            raise SystemExit(f"{flag} has no entry for frame '{key}'")
        val = spec[key]
    else:
        arr = _as_boxes(spec)
        if arr is not None and arr.ndim == 1:   # one box for every frame
            val = arr
        elif idx >= len(spec):
            raise SystemExit(f'{flag} lists only {len(spec)} entries; '
                             f'frame {idx} has none')
        else:
            val = spec[idx]
    boxes = np.asarray(val, np.float32)
    if boxes.size == 0:         # [] = a frame where nothing was detected
        return []
    if boxes.ndim == 1:
        boxes = boxes[None]
    if boxes.ndim != 2 or boxes.shape[1] != 4:
        raise SystemExit(f'{flag} entry for frame {idx} ({key}) must be '
                         '[x, y, w, h] or a list of them ([] = no '
                         'detections in that frame)')
    return list(boxes)


def expand_entries(frames, spec, flag='-bboxes'):
    """Lazily expand (key, image) frames into per-person
    (key, image, bbox, person) samples, the unit the model consumes."""
    count = 0
    for idx, (key, image) in enumerate(frames):
        count = idx + 1
        for person, box in enumerate(_frame_boxes(key, image, idx, spec,
                                                  flag)):
            yield key, image, box, person
    # a per-frame LIST longer than the stream means frames went missing
    # (glob typo, short video): don't silently drop the user's boxes
    if spec is not None and not isinstance(spec, dict):
        arr = _as_boxes(spec)
        is_single_box = arr is not None and arr.ndim == 1
        if not is_single_box and len(spec) > count:
            raise SystemExit(f'{flag} lists {len(spec)} per-frame entries '
                             f'but the stream yielded only {count} frames')


def load_box_spec(spec_path):
    """Parse a -bboxes / -depth_bboxes JSON file; None means full-frame
    boxes."""
    if spec_path is None:
        return None
    with open(spec_path) as f:
        return json.load(f)


def load_depth_frames(pattern):
    """Ordered (key, HxWx1 float32 raw-depth) frames from -depth_images."""
    paths = sorted(glob.glob(pattern))
    if not paths:
        raise SystemExit(f'no files match {pattern!r}')
    frames = []
    for path in paths:
        image = np.asarray(imread(path), np.float32)
        if image.ndim == 3:
            image = image[..., 0]
        frames.append((os.path.basename(path), image[..., None]))
    return frames


def resolve_model_path(path):
    """Accept the Logger's best.pth pointer (main.py:37-46 convention):
    {'best': E} resolves to model_<E>.pth beside it."""
    if os.path.basename(path) == 'best.pth':
        epoch = load_torch_file(path)['best']
        return os.path.join(os.path.dirname(path), f'model_{epoch}.pth')
    return path


def resolve_variant(args):
    """Model dispatch (depth_main.py:37-42): partial_/fusion/depth/rgb."""
    if (args.depth_only or args.do_fusion or args.partial_conv
            or args.depth_net):
        return (('partial_' if args.partial_conv else '')
                + ('fusion' if args.do_fusion else 'depth'))
    return 'rgb'


def load_camera(spec_path, frame_hw, focal=0.0):
    """Camera from a JSON spec, else a centered pinhole guess."""
    h, w = frame_hw
    if spec_path is None:
        focal = focal or 1.2 * max(h, w)
        K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
        return cameralib.Camera(intrinsic_matrix=K, world_up=(0, -1, 0))
    with open(spec_path) as f:
        spec = json.load(f)
    R = np.asarray(spec.get('R', np.eye(3)), np.float64)
    kwargs = dict(rot_world_to_cam=R,
                  intrinsic_matrix=np.asarray(spec['K'], np.float64),
                  world_up=tuple(spec.get('world_up', (0, -1, 0))))
    if 'optical_center' in spec:
        kwargs['optical_center'] = np.asarray(spec['optical_center'])
    else:
        t = np.asarray(spec.get('t', np.zeros(3)), np.float64).reshape(3)
        kwargs['optical_center'] = -R.T @ t
    dist = np.asarray(spec.get('dist') or [], np.float64)
    if dist.size and np.any(dist):      # explicit all-zeros IS a pinhole
        kwargs['distortion_coeffs'] = dist
    return cameralib.Camera(**kwargs)


def _crop_sample(cam, image, bbox, side_in, canvas_hw):
    """A crop camera and one sample's warp inputs: the lookup (prescaled
    with the canvas), the padded canvas and its extent."""
    new_cam, matrices = crop.build_crop(cam, bbox, side_in, do_flip=False,
                                        random_zoom=1.0, geometry_aug=False)
    canvas, extent, prescale = crop.pad_to_canvas(image, canvas_hw)
    sample = dict(matrices)
    crop.scale_lookup(sample, prescale)
    sample['canvas'] = canvas
    sample['extent'] = extent
    return new_cam, sample


def _stack(per_frame):
    return {k: np.stack([s[k] for s in per_frame]) for k in per_frame[0]}


def prepare_batch(frames, bboxes, cam, side_in, extra_channel, canvas_hw):
    """Host geometry for a chunk of frames: crop cameras, padded canvases
    and the per-sample warp lookups (the loader's parse path)."""
    new_cams, per_frame = [], []
    for (_, image), bbox in zip(frames, bboxes):
        new_cam, sample = _crop_sample(cam, image, bbox, side_in, canvas_hw)
        if extra_channel:
            bx, by, bw, bh = np.asarray(bbox, np.float32)
            corners = np.array([[bx, by], [bx + bw, by],
                                [bx + bw, by + bh], [bx, by + bh]],
                               np.float32)
            sample['bbox_quad'] = cameralib.reproject_points(
                corners, cam, new_cam).astype(np.float32)
        new_cams.append(new_cam)
        per_frame.append(sample)
    return new_cams, _stack(per_frame)


def prepare_depth_batch(frames, bboxes, cam, side_in, canvas_hw):
    """Host geometry for the depth stream (DepthPoseLoader.parse): a
    pinhole-only crop homography plus the ORIGINAL depth intrinsics'
    inverse for the to_depth correction."""
    if cam.distortion_coeffs is not None:
        raise SystemExit('-depth_camera must be pinhole (the reference '
                         'depth stores are intrinsics-only, '
                         'get_depth_cams.py)')
    k_inv = np.linalg.inv(
        cam.intrinsic_matrix.astype(np.float64)).astype(np.float32)
    new_cams, per_frame = [], []
    for (_, image), bbox in zip(frames, bboxes):
        new_cam, sample = _crop_sample(cam, image, bbox, side_in, canvas_hw)
        new_cams.append(new_cam)
        per_frame.append(sample)
    batch = _stack(per_frame)
    batch['k_inv'] = np.tile(k_inv, (len(per_frame), 1, 1))
    return new_cams, batch


def _warp_color(batch, side_in, device):
    """The colour crops on the device: the exact mxu warp (the general
    lookup for a distorted source camera), clip, normalise, and the
    bbox-mask channel under -extra_channel. Colour and erase are off, so
    no draws are needed."""
    def on(key):
        return torch.as_tensor(batch[key]).to(device)

    if 'homography' in batch:
        crops = augment.process_color_batch(
            on('canvas'), on('homography'), on('extent'), None, side_in,
            False, False, warp_impl='mxu')
    else:
        crops = augment.process_color_batch_general(
            on('canvas'), on('partial_homography'), on('old_intrinsics'),
            on('dist_coeffs'), on('extent'), None, side_in, False, False)
    if 'bbox_quad' in batch:
        mask = augment.bbox_mask_channel(on('bbox_quad'), side_in)
        crops = torch.cat([crops, mask], dim=-1)
    return crops


def _warp_depth(batch, args, device):
    thresh = np.full(len(batch['canvas']), args.depth_thresh, np.float32)
    return augment.process_depth_batch(
        *(torch.as_tensor(batch[k]).to(device)
          for k in ('canvas', 'homography', 'extent', 'k_inv')),
        torch.as_tensor(thresh).to(device), args.side_in, args.nexponent,
        args.to_depth, warp_impl='mxu')


def run_batch(predictor, args, variant, cbatch, dbatch, key_index, new_cams,
              orig_cam, calib=None, calib_target=1):
    """Warp + forward + decode for one padded chunk; returns per-frame
    result dicts in the ORIGINAL camera/world frame (`new_cams`/`orig_cam`
    are the crop/source cameras of the stream that defines the model's
    output frame: RGB when present, else depth)."""
    device = predictor.device
    if variant in ('fusion', 'partial_fusion'):
        inputs = (_warp_color(cbatch, args.side_in, device),
                  _warp_depth(dbatch, args, device))
    elif args.depth_only:
        inputs = (_warp_depth(dbatch, args, device),)
    else:
        inputs = (_warp_color(cbatch, args.side_in, device),)

    if (args.quantize and calib is not None
            and predictor._quant_scales is None):
        # running-max calibration over the first -calib_batches request
        # batches: batches before the closing one serve at full precision;
        # the closing batch calibrates AND is the first served int8
        calib.update(inputs)
        if calib.count >= calib_target:
            predictor.quantize_with_scales(calib.scales)
    out = predictor.predict_crops(*inputs)
    relat = out['relat_cam']
    relat = relat - relat[:, key_index:key_index + 1]

    results = []
    back = np.stack([orig_cam.R @ nc.R.T for nc in new_cams])  # (B, 3, 3)
    relat_orig = np.einsum('bij,bkj->bki', back, relat)
    absolute = None
    if args.joint_space and 'spec_mat' in out:
        intr = np.stack([nc.intrinsic_matrix for nc in new_cams])
        with torch.inference_mode():
            absolute = recon.recon_root(
                torch.as_tensor(out['spec_mat']).to(device),
                torch.as_tensor(relat).to(device),
                torch.as_tensor(intr.astype(np.float32)).to(device))
        absolute = absolute.cpu().numpy()
    for i, new_cam in enumerate(new_cams):
        rec = {'relat_cam': relat_orig[i].tolist()}
        if 'spec_mat' in out:
            rec['spec_mat'] = out['spec_mat'][i].tolist()
        if absolute is not None:
            world = new_cam.camera_to_world(absolute[i].astype(np.float64))
            rec['absolute_world'] = world.tolist()
            rec['absolute_cam'] = orig_cam.world_to_camera(world).tolist()
            rec['image_coord'] = orig_cam.world_to_image(world).tolist()
        results.append(rec)
    return results


def save_viz(viz_dir, key, image, rec, bbox, skeleton):
    matplotlib = _require('matplotlib', '-viz')
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    from .tools import viz

    coords = np.asarray(rec.get('image_coord', [])).T
    if coords.size == 0:
        return                  # no absolute path -> nothing in frame coords
    confidence = np.ones(coords.shape[1])
    viz.show_skeleton(image, coords[:2], confidence, message=key,
                      bbox=np.asarray(bbox), skeleton=skeleton)
    os.makedirs(viz_dir, exist_ok=True)
    fig = plt.gcf()
    fig.savefig(os.path.join(viz_dir, os.path.splitext(key)[0] + '.png'))
    plt.close(fig)


def _check_flags(args, variant, need_depth):
    """JAX's flag checks (predict.py:512-529), as SystemExit."""
    if args.do_fusion and args.depth_only:
        raise SystemExit('-do_fusion models consume BOTH streams; '
                         '-depth_only contradicts it')
    if args.joint_space and variant != 'rgb':
        raise SystemExit('-joint_space is an RGB-model head; depth-family '
                         'checkpoints have no 2D branch')
    if args.extra_channel and variant != 'rgb':
        raise SystemExit('-extra_channel (bbox mask input) exists only on '
                         'the RGB trunk (resnet.py conv1 surgery)')
    if args.depth_only and (args.bboxes or args.camera):
        raise SystemExit('-depth_only models take -depth_bboxes / '
                         '-depth_camera, not -bboxes / -camera')
    if (args.nexponent or args.to_depth) and not need_depth:
        raise SystemExit('-nexponent/-to_depth shape the DEPTH stream; '
                         f'a {variant} model without -depth_only/-do_fusion '
                         'never reads it')


def artifact_predictor(args, variant, device):
    """The ArtifactPredictor of a .pt2 -model_path, checked against the
    flags with JAX's checks and messages (predict.py:594-630)."""
    if args.quantize:
        raise SystemExit('-quantize needs a checkpoint model; a .pt2 '
                         'artifact bakes its precision at export time '
                         '(quantize before export_artifact)')
    try:
        predictor = serve.ArtifactPredictor(args.model_path, device=device)
    except ValueError as e:
        raise SystemExit(str(e))
    shape = predictor.in_shapes[0]
    if shape[1] != args.side_in:
        raise SystemExit(f'artifact expects side_in {shape[1]}, '
                         f'flags say {args.side_in}')
    n_inputs = 2 if variant in ('fusion', 'partial_fusion') else 1
    if len(predictor.in_shapes) != n_inputs:
        raise SystemExit(f'artifact takes {len(predictor.in_shapes)} '
                         f'input stream(s); the {variant} flags '
                         f'need {n_inputs}')
    want_ch = (3 if variant in ('fusion', 'partial_fusion')
               else 1 if args.depth_only
               else 4 if args.extra_channel else 3)
    if shape[3] != want_ch:
        raise SystemExit(f'artifact expects {shape[3]}-channel input; '
                         f'the flags imply {want_ch} (check '
                         '-extra_channel / -depth_only)')
    art_joints = predictor.out_shapes[0][1]
    if art_joints != args.num_joints:
        raise SystemExit(f'artifact predicts {art_joints} joints; '
                         f'flags say -num_joints {args.num_joints} '
                         '(and check -skeleton)')
    return predictor


def main(argv=None, device=None):
    """Run the CLI on `argv` (sys.argv[1:] by default) on `device` (CUDA
    by default). Returns the output blob, also written to -out."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    if args.model_path.endswith(JAX_ARTIFACT_SUFFIX):
        raise SystemExit(
            f'-model_path {args.model_path}: pose_tpu_torch reads its own '
            f'{ARTIFACT_SUFFIX} artifacts; a {JAX_ARTIFACT_SUFFIX} file is '
            'StableHLO and needs JAX (export one for the port with '
            'pose_tpu_torch.serve.Predictor.export_artifact)')
    args.model_path = resolve_model_path(args.model_path)
    variant = resolve_variant(args)
    need_color = not args.depth_only
    need_depth = args.depth_only or variant in ('fusion', 'partial_fusion')
    _check_flags(args, variant, need_depth)

    info = joints.build_info(args.skeleton)
    if len(info.short_names) == args.num_joints:
        key_index = info.key_index
    else:
        key_index = 0
        print(f'warning: -skeleton {args.skeleton} has '
              f'{len(info.short_names)} joints but -num_joints is '
              f'{args.num_joints}; rooting poses at joint 0 — pass the '
              'matching -skeleton for the trained root joint',
              file=sys.stderr)
    if args.viz and not (args.joint_space and variant == 'rgb'):
        raise SystemExit('-viz needs a -joint_space RGB model (overlays '
                         'require full-frame 2D coordinates)')
    if args.viz and len(info.short_names) != args.num_joints:
        raise SystemExit('-viz needs -skeleton matching -num_joints')
    if args.viz:
        _require('matplotlib', '-viz')
    device = runtime.resolve_device(device)

    cframes = dframes = cam = dcam = None
    cspec = dspec = None
    total = canvas_hw = dcanvas_hw = None
    if need_color:
        cframes, total, canvas_hw = load_frames(args)
        cspec = load_box_spec(args.bboxes)
        # the default-camera guess needs frame dims, which a streaming
        # -video only yields at the first chunk; defer to the loop
        if args.camera is not None:
            cam = load_camera(args.camera, (0, 0), args.focal)
    elif args.images or args.video:
        raise SystemExit('-depth_only models take only -depth_images')
    if need_depth:
        if args.depth_images is None:
            raise SystemExit(f'a {variant} model needs -depth_images')
        dframes = load_depth_frames(args.depth_images)
        dspec = load_box_spec(args.depth_bboxes)
        dcam = load_camera(args.depth_camera, dframes[0][1].shape[:2],
                           args.focal)
        if dcam.distortion_coeffs is not None:  # fail before the model init
            raise SystemExit('-depth_camera must be pinhole (the reference '
                             'depth stores are intrinsics-only, '
                             'get_depth_cams.py)')
        dcanvas_hw = (max(f.shape[0] for _, f in dframes),
                      max(f.shape[1] for _, f in dframes))

    # expand frames into per-person (key, image, bbox, person) samples;
    # eager sources expand eagerly, the -video stream stays lazy
    dentries = None
    if need_depth:
        dentries = list(expand_entries(dframes, dspec, '-depth_bboxes'))
    if need_color:
        source = expand_entries(cframes, cspec)
        if total is not None:
            source = list(source)
            total = len(source)
            if dentries is not None and total != len(dentries):
                raise SystemExit(f'-bboxes expands to {total} person '
                                 f'samples vs {len(dentries)} in '
                                 '-depth_bboxes')
    else:
        source = dentries
        total = len(dentries)

    if args.model_path.endswith(ARTIFACT_SUFFIX):
        predictor = artifact_predictor(args, variant, device)
        bs = predictor.batch_size
    else:
        pargs = serve.default_args(
            model=args.model, side_in=args.side_in, stride=args.stride,
            num_joints=args.num_joints, depth=args.depth,
            depth_range=args.depth_range, joint_space=args.joint_space,
            extra_channel=args.extra_channel, half_acc=args.half_acc,
            depth_only=args.depth_only)
        bs = max(1, min(args.batch_size, total or args.batch_size))
        predictor = serve.Predictor.from_checkpoint(
            args.model_path, pargs, variant=variant, batch_size=bs,
            device=device)

    def pad(seq, bs):
        seq = list(seq)
        while len(seq) < bs:
            seq = seq + [seq[-1]]
        return seq

    calib = calib_target = None
    if args.quantize:
        calib = predictor.make_calibrator()
        calib_target = max(1, args.calib_batches)
        if total:
            # short streams still quantize: close the window no later than
            # the final batch
            calib_target = min(calib_target, -(-total // bs))
    records = []
    start = 0
    for chunk, n in chunks_of(source, bs):
        cbatch = dbatch = None
        frames_chunk = [(k, img) for k, img, _, _ in chunk]
        chunk_boxes = [b for _, _, b, _ in chunk]
        if need_color:
            if cam is None:       # default camera: dims from the stream
                cam = load_camera(None, chunk[0][1].shape[:2], args.focal)
            if canvas_hw is None:  # video frames share one size
                canvas_hw = chunk[0][1].shape[:2]
            new_cams, cbatch = prepare_batch(
                frames_chunk, chunk_boxes, cam, args.side_in,
                args.extra_channel, canvas_hw)
            frame_cams, orig_cam = new_cams, cam
            if need_depth:
                if start + n > len(dentries):
                    raise SystemExit(f'colour stream has more person '
                                     f'samples than the {len(dentries)} '
                                     'in -depth_bboxes/-depth_images')
                dchunk = pad(dentries[start:start + n], bs)
                if [p for _, _, _, p in chunk[:n]] != [p for _, _, _, p
                                                       in dchunk[:n]]:
                    raise SystemExit('-bboxes and -depth_bboxes disagree '
                                     'on the people per frame')
                _, dbatch = prepare_depth_batch(
                    [(k, img) for k, img, _, _ in dchunk],
                    [b for _, _, b, _ in dchunk], dcam, args.side_in,
                    dcanvas_hw)
        else:                     # depth-only: the depth view IS the frame
            new_dcams, dbatch = prepare_depth_batch(
                frames_chunk, chunk_boxes, dcam, args.side_in, dcanvas_hw)
            frame_cams, orig_cam = new_dcams, dcam
        results = run_batch(predictor, args, variant, cbatch, dbatch,
                            key_index, frame_cams, orig_cam,
                            calib=calib, calib_target=calib_target)
        if calib is not None and predictor._quant_scales is not None:
            calib = None          # window closed
        start += n
        for (key, image, bbox, person), rec in list(zip(chunk,
                                                        results))[:n]:
            rec = dict(rec, key=key, person=person,
                       bbox=np.asarray(bbox).tolist())
            records.append(rec)
            if args.viz:
                stem, ext = os.path.splitext(key)
                viz_key = key if person == 0 else f'{stem}_p{person}{ext}'
                save_viz(args.viz, viz_key, image, rec, bbox,
                         args.skeleton)

    if not records:
        raise SystemExit('the input stream yielded no person samples '
                         '(no frames, or every bbox entry was empty)')
    if calib is not None and predictor._quant_scales is None:
        # only reachable with -video (unknown total, so the window can't be
        # pre-clamped): the clip ended inside the calibration window
        print(f'[predict] WARNING: -quantize never activated — the stream '
              f'ended after {calib.count} batch(es), inside the '
              f'-calib_batches {args.calib_batches} window; every batch '
              'served at full precision', file=sys.stderr)
    if args.track_ids:
        from .tools.tracking import assign_track_ids
        assign_track_ids(records)
    if need_color and need_depth and start != len(dentries):
        raise SystemExit(f'{start} colour person samples vs '
                         f'{len(dentries)} in -depth_bboxes/-depth_images')

    blob = dict(model=args.model, model_path=args.model_path,
                variant=variant, side_in=args.side_in,
                num_joints=args.num_joints, skeleton=args.skeleton,
                frames=records)
    with open(args.out, 'w') as f:
        json.dump(blob, f)
    print(f'=> wrote {len(records)} predictions to {args.out}')
    return blob


if __name__ == '__main__':
    main(sys.argv[1:])
