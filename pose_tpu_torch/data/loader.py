"""Host data loader feeding the device preprocessing (port of
pose_tpu/data/loader.py: the RGB `PoseLoader`, the depth/fusion
`DepthPoseLoader`, `data_loader` and `depth_data_loader`).

Per sample, the host decodes the image, draws flip and zoom, builds the
crop camera (3x3 math) and transforms the GT joints; whole canvases go to
the device, where the warp, clip, normalisation and the bbox-mask channel
run batched (`data.augment`). Flip and zoom come from a numpy RandomState
seeded per (seed, epoch, index), and the order from a RandomState seeded
per (seed, epoch), so every host array of a batch (homography, true_cam,
true_val, true_mat, intrinsics, bbox_quad, back_rotation) equals JAX's;
the epoch advances after each train iteration (loader.py:575-576).

Warp choice per batch (loader.py:146-152, the card in the TPU's place):
train `split` on the card (the split-warp kernel, gated per batch by
`warp.split_band_ok`, `mxu` for a batch the gate rejects) and `mxu`
elsewhere; eval `mxu` on the card unless -strict_eval, `gather` elsewhere.
POSE_TPU_WARP and POSE_TPU_EVAL_WARP override them, as in JAX.

Decode (loader.py:154-162, 295-317): the native C++ pool
(`native_loader`, -workers C++ threads) for a batch whose paths are all
.jpg/.jpeg (.png for the depth stream), PIL and numpy per sample
otherwise; both give the same canvases. Unlike JAX, which drops any
failure to build the pool silently, a loader records the decoder it built
(`decoder`, and `depth_decoder` for the depth stream: 'native' or 'pil')
and why the pool was not taken (`decoder_reason`), and prints it once.

The depth loader (loader.py:579-797) runs the crop twice per sample, for
the colour frame and for the depth frame with its own camera and
depth_bbox, with one flip/zoom draw; the depth stream goes through
`augment.process_depth_batch` (the gated warp in training, on the depth
canvas's shape; at test `mxu` on the card, `gather` on the CPU and under
-strict_eval) with the enhance threshold of its dataset (0.1 NTU, 0.5
PKU), and -do_teach adds the -attention map (NHWC).

Training augmentations (loader.py:112-115, 164-167, 431-463), off at
test as in JAX: -colour and -eraser run on the warped crops; -occluder
with -occ_path loads the sprite bank once (`ops.occluder`) and pastes on
every train batch. A batch of distorted source cameras (any row with
coefficients) takes the general lookup, then the paste; otherwise a
loaded bank takes the matmul warp and the paste; otherwise the gated
warp. `impl_counts` records which ('general', 'occluded' or the warp).
The random scalars of a batch come from `augment.draw_augment` on a CPU
generator seeded per (seed, epoch, batch index), so they do not depend on
the device or on the worker that decoded the batch; JAX draws them from
fold_in(PRNGKey(seed + 7919 epoch), i_batch), which a test can pass in
through `augment_draws`.

Differences from JAX, by design of this slice: one process on one device
(no `_shard_indices`; nothing is padded to a mesh, and `_true_size` is the
batch's own size); the random scalars come from torch's generator, not
from jax.random. Batches reach the device from pinned host memory with
non_blocking copies.

`attention_map` is the distillation's -attention weight (utils.py:14-42).
"""

import collections
import os
import threading
import time

import numpy as np
import torch
from PIL import Image

from .. import runtime
from ..geometry import funcam
from ..ops import occluder, warp
from . import augment, crop, native_loader, samples as sample_lib


def imread(path):
    """matplotlib.image.imread semantics (datasets.py:118): PNG -> float32 in
    [0, 1] (16-bit scaled by 65535), everything else -> uint8."""
    with Image.open(path) as img:
        arr = np.asarray(img)
    if os.path.splitext(path)[1].lower() == '.png':
        if arr.dtype == np.uint16 or arr.dtype == np.int32:
            return arr.astype(np.float32) / 65535.0
        return arr.astype(np.float32) / 255.0
    return arr


def condition_image(image):
    """Normalize an imread result to HxWx3 uint8 RGB (gray replicated,
    alpha stripped, PNG floats rescaled; datasets.py:118-121)."""
    if image.ndim == 2:
        image = image[..., None].repeat(3, axis=-1)
    image = image[..., :3]
    if image.dtype != np.uint8:
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    return image


def attention_map(side_in, stride, image_coords, attention):
    """utils.get_attention (loader.py:62-74): (1, side_out, side_out) f32,
    ones without -attention, else the sum of unit Gaussians (variance 2.5
    output cells) at each joint's 2D position on the output grid,
    normalised to a maximum of 1. image_coords: (J, 2+) crop pixels."""
    side_out = (side_in - 1) // stride + 1
    if not attention:
        return np.ones((1, side_out, side_out), np.float32)
    cx, cy = np.meshgrid(np.arange(side_out), np.arange(side_out))
    cx = np.expand_dims(cx, -1)
    cy = np.expand_dims(cy, -1)
    dist_x = cx - image_coords[:, 0] / (side_in / side_out)
    dist_y = cy - image_coords[:, 1] / (side_in / side_out)
    radial = np.exp(-(dist_x ** 2 + dist_y ** 2) / 5.0).sum(axis=-1)
    radial = radial / np.amax(radial)
    return radial[None].astype(np.float32)


def make_pool(cls, canvas_hw, workers):
    """A native decode pool of `workers` threads, or None and the reason
    it could not be built."""
    try:
        return cls(canvas_hw, num_threads=max(workers, 1)), None
    except native_loader.PoolUnavailable as e:
        return None, str(e)


class PoseLoader:
    """RGB loader (reference Dataset, datasets.py:36-154).

    Yields dict batches: 'image' (B, side_in, side_in, 3 or 4) f32 NHWC on
    the device (the bbox-mask 4th channel with -extra_channel), true_cam,
    true_val [+ true_mat, intrinsics with -joint_space] on the device,
    back_rotation (host numpy) at test, and `_true_size`."""

    def __init__(self, args, phase, data_info, samples=None, canvas=None,
                 seed=0, device=None):
        assert len(data_info.short_names) == args.num_joints
        self.args = args
        self.phase = phase
        self.data_info = data_info
        self.at_test = phase != 'train'
        self.device = runtime.resolve_device(device)

        if samples is None:
            metadata = sample_lib.load_metadata(args)
            root = metadata['root'][args.data_name]
            samples = sample_lib.get_samples(args.data_name, root, phase)
        self.samples = samples

        self.side_in = args.side_in
        self.colour = args.colour and (not self.at_test)
        self.geometry = args.geometry and (not self.at_test)
        self.eraser = args.eraser and (not self.at_test)
        self.occluder = args.occluder and (not self.at_test)
        self.random_zoom = args.random_zoom
        self.joint_space = getattr(args, 'joint_space', False)
        self.extra_channel = getattr(args, 'extra_channel', False)
        self.batch_size = args.batch_size
        self.shuffle = args.shuffle and (not self.at_test)
        self.seed = seed
        self.epoch = 0
        # mid-epoch resume: the next iteration starts at this batch
        self.start_batch = 0
        self.canvas = canvas or (512, 512)
        on_card = self.device.type == 'cuda'
        self.warp_impl = os.environ.get('POSE_TPU_WARP',
                                        'split' if on_card else 'mxu')
        default_eval = ('gather' if (getattr(args, 'strict_eval', False)
                                     or not on_card) else 'mxu')
        self.eval_warp_impl = os.environ.get('POSE_TPU_EVAL_WARP',
                                             default_eval)
        # per iteration: the host ms of each batch's decode (its worker's
        # clock) and, on the card, a CUDA event recorded on the stream as
        # each batch's warp is enqueued plus one at the end, so consecutive
        # events bracket one batch's warp and the step that consumed it;
        # and the warps the batches took
        self.log = []
        self.impl_counts = collections.Counter()
        self._native, self.decoder_reason = make_pool(
            native_loader.NativeImageLoader, self.canvas,
            getattr(args, 'workers', 1))
        self.decoder = 'pil' if self._native is None else 'native'
        self._say_decoder('colour', self.decoder, self.decoder_reason)
        self._occ_bank = None
        if self.occluder and args.occ_path:
            self._occ_bank = tuple(
                torch.from_numpy(a).to(self.device)
                for a in occluder.load_occluder_bank(args.occ_path,
                                                     args.occ_count))

    def _say_decoder(self, stream, decoder, reason):
        how = ('the native pool' if decoder == 'native'
               else f'PIL (native pool unavailable: {reason})')
        print(f'=> {self.phase} loader decodes {stream} with {how}',
              flush=True)

    def __len__(self):
        return (len(self.samples) + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    # ------------------------------------------------------------ per batch

    def _rng(self, index):
        return np.random.RandomState(
            (self.seed * 1000003 + self.epoch * 9176 + index) % (2 ** 31))

    def _order(self):
        order = np.arange(len(self.samples))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def _draws(self, idxs):
        """Per-sample flip/zoom draws (loader.py:230-238)."""
        flips, zooms = [], []
        for i in idxs:
            rng = self._rng(int(i))
            flips.append((not self.at_test) and bool(rng.rand() < 0.5))
            zooms.append(rng.uniform(self.random_zoom,
                                     self.random_zoom ** (-1)))
        return np.asarray(flips, bool), np.asarray(zooms, np.float32)

    def parse_batch(self, idxs):
        """Every non-pixel per-sample array of a batch, vectorized
        (loader.py:240-279). Returns (batch dict, image paths)."""
        samples = [self.samples[int(i)] for i in idxs]
        flips, zooms = self._draws(idxs)
        cams = funcam.stack([s['camera'].arrays() for s in samples])
        bboxes = np.stack([np.asarray(s['bbox'], np.float32)
                           for s in samples])
        new_cams, matrices = crop.build_crop_batch(
            cams, bboxes, self.side_in, flips, zooms, self.geometry)

        coords, valid, back = crop.transform_gt_batch(
            cams, new_cams,
            np.stack([s['skeleton'] for s in samples]),
            np.stack([s['valid'] for s in samples]),
            self.data_info.mirror, flips, self.at_test)

        out = dict(true_cam=coords, true_val=valid.astype(bool))
        out.update(matrices)
        if self.extra_channel:
            corners = np.stack([
                bboxes[:, :2],
                bboxes[:, :2] + bboxes[:, 2:] * [1, 0],
                bboxes[:, :2] + bboxes[:, 2:],
                bboxes[:, :2] + bboxes[:, 2:] * [0, 1]], axis=1)
            out['bbox_quad'] = funcam.reproject_pixels(
                corners.astype(np.float32), cams, new_cams)
        if self.joint_space:
            out['true_mat'] = funcam.project(new_cams, coords)
            out['intrinsics'] = new_cams.kmat.astype(np.float32)
        if back is not None:
            out['back_rotation'] = back
        return out, [s['image'] for s in samples]

    @staticmethod
    def _scale_lookup_batch(batch, prescales, key=None):
        """Fold per-sample (sy, sx) decode prescales (B, 2) into the lookup
        matrix under `key` (loader.py:281-293); by default the colour
        stream's: its `homography`, or for a distorted batch, whose pixel
        coordinates come from the source intrinsics, `old_intrinsics`."""
        if not np.any(prescales != 1.0):
            return
        if key is None:
            key = 'homography' if 'homography' in batch else 'old_intrinsics'
        batch[key] = np.array(batch[key], np.float32)
        batch[key][:, 0] *= prescales[:, 1, None]    # x-row by sx
        batch[key][:, 1] *= prescales[:, 0, None]    # y-row by sy

    def _decode_images(self, paths, canvas_hw, native_pool, grayscale=False):
        """Decode a batch of images onto fixed canvases (loader.py:295-317):
        the native pool when every path is a JPEG (a PNG for the grayscale
        depth stream), PIL per sample otherwise."""
        exts = ('.png',) if grayscale else ('.jpg', '.jpeg')
        if native_pool is not None and all(
                p.lower().endswith(exts) for p in paths):
            return native_pool.decode_batch(paths)
        canvases, extents, prescales = [], [], []
        for path in paths:
            image = imread(path)
            if grayscale:
                if image.ndim == 3:
                    image = image[..., 0]
                image = image[..., None].astype(np.float32)
            else:
                image = condition_image(image)
            cv, ext, pre = crop.pad_to_canvas(image, canvas_hw)
            canvases.append(cv)
            extents.append(ext)
            prescales.append(pre)
        return (np.stack(canvases), np.stack(extents),
                np.asarray(prescales, np.float32))

    def _decode_batch(self, idxs):
        """Per-batch host work: the camera and GT math and the decode
        (loader.py:319-327)."""
        batch, paths = self.parse_batch(idxs)
        canvases, extents, prescales = self._decode_images(
            paths, self.canvas, self._native)
        batch['canvas'] = canvases
        batch['extent'] = extents
        self._scale_lookup_batch(batch, prescales)
        return batch

    def _gated_impl(self, homographies, src_hw=None):
        """Per-batch resampler (loader.py:329-350): the split and banded
        warps fall back to the exact mxu warp for a batch their host gates
        reject; the banded gate checks the source canvas `src_hw` (the
        colour canvas by default). Call with the host homographies."""
        impl = self.eval_warp_impl if self.at_test else self.warp_impl
        if impl == 'pallas_banded':
            from ..ops.warp_cuda import band_ok_v2
            if not band_ok_v2(np.asarray(homographies),
                              src_hw or self.canvas,
                              (self.side_in, self.side_in)):
                impl = 'mxu'
        elif impl in ('split', 'split_mxu'):
            if not warp.split_band_ok(np.asarray(homographies),
                                      (self.side_in, self.side_in)):
                impl = 'mxu'
        return impl

    def _mark(self, events):
        if self.device.type == 'cuda':
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

    def step_ms(self, epoch=-1):
        """Device ms between consecutive batches of one iteration (the
        last by default): each batch's warp and the work queued after it
        until the next batch (a train or eval step). Synchronizes."""
        events = self.log[epoch]['events']
        torch.cuda.synchronize(self.device)
        return [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    def _upload(self, array):
        """A host array on the device: through pinned memory with a
        non_blocking copy on the card, as it is on the CPU."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != 'cuda':
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def augment_draws(self, i_batch, b):
        """The random scalars of batch `i_batch` of the current epoch (b
        images): `augment.draw_augment` on a CPU generator seeded per
        (seed, epoch, i_batch)."""
        gen = torch.Generator().manual_seed(
            ((self.seed + 7919 * self.epoch) * 1000003 + i_batch) % 2 ** 63)
        n = 1 if self._occ_bank is None else len(self._occ_bank[0])
        return augment.draw_augment(gen, b, n)

    def _colour_stream(self, batch, i_batch):
        """Colour canvases -> augmented, normalised NHWC crops, shared by
        both loaders (loader.py:431-463): the general lookup for a
        distorted batch, else the paste when a bank is loaded, else the
        gated warp."""
        draws = None
        if self.colour or self.eraser or self._occ_bank is not None:
            draws = augment.AugmentDraws(*(
                self._upload(t.numpy()) for t in self.augment_draws(
                    i_batch, len(batch['canvas']))))
        args = (self.side_in, self.colour, self.eraser)
        if 'partial_homography' in batch:
            self.impl_counts['general'] += 1
            return augment.process_color_batch_general(
                *(self._upload(batch.pop(k)) for k in (
                    'canvas', 'partial_homography', 'old_intrinsics',
                    'dist_coeffs', 'extent')), draws, *args,
                bank=self._occ_bank)
        if self._occ_bank is not None:
            self.impl_counts['occluded'] += 1
            return augment.process_color_batch_occluded(
                *(self._upload(batch.pop(k)) for k in (
                    'canvas', 'homography', 'extent')), draws,
                self._occ_bank, *args)
        impl = self._gated_impl(batch['homography'])
        self.impl_counts[impl] += 1
        return augment.process_color_batch(
            *(self._upload(batch.pop(k)) for k in (
                'canvas', 'homography', 'extent')), draws, *args,
            warp_impl=impl)

    def _finalize(self, batch, i_batch):
        """Host batch -> device batch (loader.py:466-482): the colour
        stream, the bbox-mask channel."""
        true_n = len(batch['canvas'])
        host = {k: batch.pop(k) for k in ('back_rotation',) if k in batch}
        image = self._colour_stream(batch, i_batch)
        if 'bbox_quad' in batch:
            mask = augment.bbox_mask_channel(
                self._upload(batch.pop('bbox_quad')), self.side_in)
            image = torch.cat([image, mask], dim=-1)
        out = dict(image=image)
        out.update({k: self._upload(v) for k, v in batch.items()})
        out.update(host)
        out['_true_size'] = true_n
        return out

    def __iter__(self):
        """One epoch of batches in the seeded order; -workers threads decode
        whole batches ahead, and a reorder buffer keeps the order
        (loader.py:484-576). `start_batch` fast-forwards once: batches
        before it are never decoded, every later batch keeps its index in
        the uninterrupted epoch, and so its draws (loader.py:495-496)."""
        start = self.start_batch
        self.start_batch = 0
        order = self._order()
        bs = self.batch_size
        batches = [order[i:i + bs] for i in range(0, len(order), bs)]
        n_workers = max(getattr(self.args, 'workers', 1), 1)
        decode_ms, events = [], []
        self.log.append(dict(decode_ms=decode_ms, events=events))
        next_idx = [start]
        ready = {}
        lock = threading.Lock()
        avail = threading.Condition(lock)
        stop = [False]

        def produce():
            while True:
                with lock:
                    # bound the reorder buffer so a fast worker cannot run
                    # ahead unboundedly
                    while (not stop[0] and next_idx[0] < len(batches)
                           and len(ready) >= 2 * n_workers):
                        avail.wait()
                    i = next_idx[0]
                    if stop[0] or i >= len(batches):
                        return
                    next_idx[0] = i + 1
                t0 = time.perf_counter()
                try:
                    batch = self._decode_batch(batches[i])
                except BaseException as e:
                    # delivered at this batch's slot, so the consumer
                    # raises instead of waiting forever
                    batch = e
                with lock:
                    decode_ms.append((time.perf_counter() - t0) * 1e3)
                    ready[i] = batch
                    avail.notify_all()
                    if isinstance(batch, BaseException):
                        return

        threads = [threading.Thread(target=produce, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        try:
            for i_batch in range(start, len(batches)):
                with lock:
                    while i_batch not in ready:
                        avail.wait()
                    batch = ready.pop(i_batch)
                    avail.notify_all()
                if isinstance(batch, BaseException):
                    raise batch
                self._mark(events)
                yield self._finalize(batch, i_batch)
            self._mark(events)
        finally:
            with lock:
                stop[0] = True
                avail.notify_all()
            for t in threads:
                t.join()
        if not self.at_test:
            self.epoch += 1


class DepthPoseLoader(PoseLoader):
    """Depth/fusion loader (reference depth Dataset,
    depth_datasets.py:59-263; loader.py:579-797). Yields dict batches:
    'color' (B, side_in, side_in, 3) and 'depth' (B, side_in, side_in, 1)
    f32 NHWC on the device, true_cam, true_val [+ atten_map
    (B, side_out, side_out, 1) under -do_teach in training] on the device,
    back_rotation (host numpy) at test, and `_true_size`."""

    def __init__(self, args, phase, data_info, samples=None, canvas=None,
                 depth_canvas=None, seed=0, root=None, device=None):
        if samples is None or root is None:
            metadata = sample_lib.load_metadata(args)
            root = root or metadata['root'][args.data_name]
            if samples is None:
                samples = sample_lib.get_samples(args.data_name, root, phase)
        super().__init__(args, phase, data_info, samples, canvas, seed,
                         device)
        self.root = root
        self.depth_canvas = depth_canvas or (424, 512)
        self._dnative, self.depth_decoder_reason = make_pool(
            native_loader.NativeDepthLoader, self.depth_canvas,
            getattr(args, 'workers', 1))
        self.depth_decoder = 'pil' if self._dnative is None else 'native'
        self._say_decoder('depth', self.depth_decoder,
                          self.depth_decoder_reason)
        self.depth_cams = sample_lib.load_depth_cameras(args.data_name, root)
        self.do_teach = args.do_teach
        self.attention = args.attention
        self.stride = args.stride
        self.nexponent = args.nexponent
        self.apply_to_depth = args.to_depth
        # the validity threshold of enhance_ntu / enhance_pku, not the
        # metric thresholds of metadata.json
        self.enhance_thresh = 0.1 if args.data_name == 'ntu' else 0.5
        self.depth_impl_counts = collections.Counter()

    def parse_batch(self, idxs):
        """Both crops of a batch, vectorized (loader.py:612-660): the colour
        and depth crop cameras share one flip/zoom draw per sample. Returns
        (batch dict, colour paths, depth paths)."""
        samples = [self.samples[int(i)] for i in idxs]
        flips, zooms = self._draws(idxs)
        cams = funcam.stack([s['camera'].arrays() for s in samples])
        depth_cams = [sample_lib.depth_cam_for(self.args.data_name,
                                               self.depth_cams, s)
                      for s in samples]
        dcams = funcam.stack([c.arrays() for c in depth_cams])

        new_cams, matrices = crop.build_crop_batch(
            cams, np.stack([np.asarray(s['bbox'], np.float32)
                            for s in samples]),
            self.side_in, flips, zooms, self.geometry)
        _, dmatrices = crop.build_crop_batch(
            dcams, np.stack([np.asarray(s['depth_bbox'], np.float32)
                             for s in samples]),
            self.side_in, flips, zooms, self.geometry)
        if 'homography' not in dmatrices:
            raise ValueError(
                'depth cameras are intrinsics-only in every reference store '
                '(get_depth_cams.py builds pinhole intrinsics); a distorted '
                'depth camera has no batched warp path')

        coords, valid, back = crop.transform_gt_batch(
            cams, new_cams,
            np.stack([s['skeleton'] for s in samples]),
            np.stack([s['valid'] for s in samples]),
            self.data_info.mirror, flips, self.at_test)

        out = dict(depth_homography=dmatrices['homography'],
                   depth_k_inv=np.linalg.inv(
                       dcams.kmat.astype(np.float64)).astype(np.float32),
                   true_cam=coords, true_val=valid.astype(bool))
        out.update(matrices)
        if back is not None:
            out['back_rotation'] = back
        elif self.do_teach:
            image_coords = funcam.project(new_cams, coords)
            out['atten_map'] = np.stack([
                attention_map(self.side_in, self.stride, image_coords[i],
                              self.attention) for i in range(len(samples))])
        paths = [s['image'] for s in samples]
        depth_paths = [sample_lib.depth_image_path(self.args.data_name,
                                                   self.root, s)
                       for s in samples]
        return out, paths, depth_paths

    def _decode_batch(self, idxs):
        """Per-batch host work (loader.py:662-677): the camera math, the
        colour JPEGs and the depth PNGs, each decode's prescale folded into
        its own homography."""
        batch, paths, depth_paths = self.parse_batch(idxs)
        canvases, extents, prescales = self._decode_images(
            paths, self.canvas, self._native)
        dcanvases, dextents, dprescales = self._decode_images(
            depth_paths, self.depth_canvas, self._dnative, grayscale=True)
        batch['canvas'] = canvases
        batch['extent'] = extents
        self._scale_lookup_batch(batch, prescales)
        batch['depth_canvas'] = dcanvases
        batch['depth_extent'] = dextents
        self._scale_lookup_batch(batch, dprescales, key='depth_homography')
        return batch

    def _finalize(self, batch, i_batch):
        """Host batch -> device batch (loader.py:759-797): the colour
        stream, the depth stream's warp, ray correction and enhance, the
        attention map to NHWC."""
        true_n = len(batch['canvas'])
        host = {k: batch.pop(k) for k in ('back_rotation',) if k in batch}
        color = self._colour_stream(batch, i_batch)
        host_depth_homs = batch['depth_homography']
        if self.at_test:
            depth_impl = 'mxu' if self.eval_warp_impl == 'mxu' else 'gather'
        else:
            depth_impl = self._gated_impl(host_depth_homs,
                                          src_hw=self.depth_canvas)
        self.depth_impl_counts[depth_impl] += 1
        thresh = np.full((len(host_depth_homs),), self.enhance_thresh,
                         np.float32)
        depth = augment.process_depth_batch(
            self._upload(batch.pop('depth_canvas')),
            self._upload(batch.pop('depth_homography')),
            self._upload(batch.pop('depth_extent')),
            self._upload(batch.pop('depth_k_inv')), self._upload(thresh),
            self.side_in, self.nexponent, self.apply_to_depth,
            warp_impl=depth_impl)
        if 'atten_map' in batch:
            # (B, 1, S, S) -> NHWC (B, S, S, 1), to broadcast over the
            # feature channels in the distillation loss
            batch['atten_map'] = batch['atten_map'].transpose(0, 2, 3, 1)
        out = dict(color=color, depth=depth)
        out.update({k: self._upload(v) for k, v in batch.items()})
        out.update(host)
        out['_true_size'] = true_n
        return out


def data_loader(args, phase, data_info, **kwargs):
    """datasets.data_loader (datasets.py:22-27; loader.py:800-802)."""
    return PoseLoader(args, phase, data_info, **kwargs)


def depth_data_loader(args, phase, data_info, **kwargs):
    """depth_datasets.data_loader (depth_datasets.py:23-28;
    loader.py:805-807)."""
    return DepthPoseLoader(args, phase, data_info, **kwargs)
