"""Train and eval steps of the RGB and depth engines (port of
pose_tpu/train/steps.py).

JAX's steps are pure jitted functions of a TrainState. Here a step runs
eagerly and UPDATES THE MODEL AND THE OPTIMIZER IN PLACE: the parameters
(f32 masters), the BN running statistics (f32 buffers, updated by the BN
modules during the forward) and the Adam moments. It returns the loss
dict, as device tensors; nothing in a step waits for the card.

- `-half_acc` is `steps._apply` (steps.py:101-120), not torch.autocast:
  the master parameters are cast to bf16 for the forward (through
  torch.func.functional_call, so gradients reach the f32 masters through
  the cast), the inputs are cast to bf16, and the head outputs are cast to
  f32 before the decode and the loss. Without -half_acc the compute dtype
  is the masters' dtype (f32; f64 in the f64 lockstep tests), and head
  outputs are promoted to at least f32.
- The optimizer is optax's chain (steps.py:36-41), not torch's Adam:
  clip_by_global_norm (g * max_norm / |g| where |g| >= max_norm, no
  epsilon), then weight decay added to the gradient, then Adam (b1 0.9,
  b2 0.999, eps 1e-8, bias-corrected), then params -= lr * update.
- Each train step is a named range of a profiler trace
  (`<kind>_train_step`, with `backward` and `optimizer` inside).
"""

import functools
from dataclasses import dataclass

import torch

from ..ops import heatmap, recon
from ..utils.profiling import annotate
from . import losses


class ClipDecayAdam:
    """optax.chain(clip_by_global_norm(grad_norm),
    add_decayed_weights(weight_decay), scale_by_adam(0.9, 0.999, 1e-8))
    followed by params += -lr * update (steps.py:36-41, :134-139), over
    the params' .grad, with no host sync. `last_norm` is the last step's
    global gradient norm (a device scalar)."""

    def __init__(self, params, grad_norm, weight_decay, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params = list(params)
        self.grad_norm = float(grad_norm)
        self.weight_decay = float(weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.last_norm = None

    @torch.no_grad()
    def step(self, lr):
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        # clip_by_global_norm: select(|g| < max, g, (g / |g|) * max)
        g_norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        keep = g_norm < self.grad_norm
        torch._foreach_div_(grads, torch.where(keep, 1.0, g_norm))
        torch._foreach_mul_(grads, torch.where(
            keep, 1.0, torch.full_like(g_norm, self.grad_norm)))
        # add_decayed_weights: g + wd * p
        if self.weight_decay:
            torch._foreach_add_(grads, self.params, alpha=self.weight_decay)
        # scale_by_adam
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        nu_hat = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        torch._foreach_div_(mu_hat, nu_hat)
        # params + (-lr * update)
        torch._foreach_mul_(mu_hat, -lr)
        torch._foreach_add_(self.params, mu_hat)
        self.last_norm = g_norm


def make_optimizer(args, params):
    return ClipDecayAdam(params, args.grad_norm, args.weight_decay)


@dataclass
class TrainState:
    """The model (f32 master parameters, BN running statistics), its
    optimizer and the count of steps taken (steps.py:28-33)."""
    model: torch.nn.Module
    tx: ClipDecayAdam
    step: int = 0


def init_state(model, args):
    """A TrainState over the model's parameters as they are (place the
    model on its device first)."""
    return TrainState(model, make_optimizer(args, model.parameters()))


def compute_dtype(args, model):
    """bf16 under -half_acc, else the master parameters' dtype."""
    if args.half_acc:
        return torch.bfloat16
    return next(model.parameters()).dtype


def image_input(image):
    """NHWC batch image -> NCHW with channels_last strides, no copy."""
    return torch.as_tensor(image).permute(0, 3, 1, 2)


def _apply(model, inputs, train, dtype):
    """Forward with the parameters and the float inputs cast to `dtype`
    (steps.py:101-120); float outputs promoted to at least f32. BN
    statistics stay in the model's own (f32) buffers and, in train mode,
    are updated in place."""
    model.train(train)
    inputs = tuple(x.to(dtype) if x.is_floating_point() else x
                   for x in inputs)
    params = {n: p.to(dtype) for n, p in model.named_parameters()}
    out = torch.func.functional_call(model, params, inputs)

    def up(x):
        return x.to(torch.promote_types(x.dtype, torch.float32))
    return tuple(map(up, out)) if isinstance(out, tuple) else up(out)


def decode_spec_cam(cam_feat, depth, num_joints, depth_range, key_index,
                    true_cam):
    """Volumetric soft-argmax -> root-relative -> plus the GT root
    (steps.py:123-131)."""
    hm = heatmap.to_heatmap3d(cam_feat, depth, num_joints)
    relat = heatmap.decode3d(hm, depth_range)
    relat = relat - relat[:, key_index:key_index + 1]
    spec = relat + true_cam[:, key_index:key_index + 1]
    return relat, spec


def _update(state, loss, lr):
    for p in state.tx.params:
        p.grad = None
    with annotate('backward'):
        loss.backward()
    with annotate('optimizer'):
        state.tx.step(lr)
    state.step += 1


def _named(name, step):
    """`step` as one named range of a profiler trace."""
    @functools.wraps(step)
    def named(*args, **kwargs):
        with annotate(name):
            return step(*args, **kwargs)
    return named


def make_cam_train_step(args, key_index):
    """cam_train (steps.py:145-169): the 3D loss only.
    step(state, batch, lr) -> {'cam_loss'}."""
    criterion = losses.get_criterion(args.criterion)

    def step(state, batch, lr):
        cam_feat = _apply(state.model, (image_input(batch['image']),), True,
                          compute_dtype(args, state.model))
        _, spec = decode_spec_cam(cam_feat, args.depth, args.num_joints,
                                  args.depth_range, key_index,
                                  batch['true_cam'])
        loss = losses.masked_mean_loss(criterion, spec, batch['true_cam'],
                                       batch['true_val'])
        _update(state, loss, lr)
        return {'cam_loss': loss.detach()}

    return _named('cam_train_step', step)


def make_joint_train_step(args, key_index, do_track):
    """joint_train (steps.py:172-214): 2D + 3D losses and, with do_track,
    the reconstruction loss: loss = 0.5 * (cam + mat) + recon.
    step(state, batch, lr) -> {'cam_loss', 'mat_loss', 'recon_loss'}."""
    criterion = losses.get_criterion(args.criterion)

    def step(state, batch, lr):
        cam_feat, mat_feat = _apply(state.model,
                                    (image_input(batch['image']),), True,
                                    compute_dtype(args, state.model))
        hm2 = heatmap.to_heatmap2d(mat_feat, args.num_joints)
        spec_mat = heatmap.decode2d(hm2, args.side_in)
        mat_loss = losses.masked_mean_loss(
            criterion, spec_mat, batch['true_mat'], batch['true_val'])
        relat, spec = decode_spec_cam(cam_feat, args.depth, args.num_joints,
                                      args.depth_range, key_index,
                                      batch['true_cam'])
        cam_loss = losses.masked_mean_loss(
            criterion, spec, batch['true_cam'], batch['true_val'])
        loss = cam_loss + mat_loss
        recon_loss = torch.zeros((), dtype=loss.dtype, device=loss.device)
        if do_track:
            recon_cam = recon.recon_root(spec_mat, relat,
                                         batch['intrinsics'])
            recon_loss = losses.masked_mean_loss(
                criterion, recon_cam, batch['true_cam'], batch['true_val'])
            loss = loss * 0.5 + recon_loss
        _update(state, loss, lr)
        return {'cam_loss': cam_loss.detach(), 'mat_loss': mat_loss.detach(),
                'recon_loss': recon_loss.detach()}

    return _named('joint_train_step', step)


def make_rgb_eval_step(args, key_index):
    """Forward with BN in eval mode + decode (steps.py:217-248).
    step(state, batch) -> {'relat_cam', 'spec_cam', 'cam_loss'} and, with
    joint_space, {'spec_mat', 'mat_loss'}."""
    criterion = losses.get_criterion(args.criterion)

    @torch.no_grad()
    def step(state, batch):
        out = _apply(state.model, (image_input(batch['image']),), False,
                     compute_dtype(args, state.model))
        result = {}
        if args.joint_space:
            cam_feat, mat_feat = out
            hm2 = heatmap.to_heatmap2d(mat_feat, args.num_joints)
            spec_mat = heatmap.decode2d(hm2, args.side_in)
            result['spec_mat'] = spec_mat
            result['mat_loss'] = losses.masked_mean_loss(
                criterion, spec_mat, batch['true_mat'], batch['true_val'])
        else:
            cam_feat = out
        relat, spec = decode_spec_cam(cam_feat, args.depth, args.num_joints,
                                      args.depth_range, key_index,
                                      batch['true_cam'])
        result['relat_cam'] = relat
        result['spec_cam'] = spec
        result['cam_loss'] = losses.masked_mean_loss(
            criterion, spec, batch['true_cam'], batch['true_val'])
        return result

    return step


# ------------------------------------------------------------ depth engine


def _depth_cam_loss(criterion, spec, true_cam, valid, loss_div):
    """The depth engine divides both sides by loss_div before the criterion
    (steps.py:254-258)."""
    return losses.masked_mean_loss(criterion, spec / loss_div,
                                   true_cam / loss_div, valid)


def _decode_loss(args, key_index, criterion, cam_feat, batch):
    relat, spec = decode_spec_cam(cam_feat, args.depth, args.num_joints,
                                  args.depth_range, key_index,
                                  batch['true_cam'])
    return relat, spec, _depth_cam_loss(criterion, spec, batch['true_cam'],
                                        batch['true_val'], args.loss_div)


def _cam_only_step(args, key_index, keys, name):
    """A step whose model reads the batch's `keys` (NHWC images) and
    returns (cam_feat, tap); the loss is the depth engine's cam loss."""
    criterion = losses.get_criterion(args.criterion)

    def step(state, batch, lr):
        cam_feat, _ = _apply(state.model,
                             tuple(image_input(batch[k]) for k in keys),
                             True, compute_dtype(args, state.model))
        _, _, loss = _decode_loss(args, key_index, criterion, cam_feat, batch)
        _update(state, loss, lr)
        return {'cam_loss': loss.detach()}

    return _named(name, step)


def make_vanilla_train_step(args, key_index):
    """vanilla_train (steps.py:261-287): one modality, the batch's
    'in_image'. step(state, batch, lr) -> {'cam_loss'}."""
    return _cam_only_step(args, key_index, ('in_image',),
                          'vanilla_train_step')


def make_fusion_train_step(args, key_index):
    """fusion_train (steps.py:290-316): model(color, depth).
    step(state, batch, lr) -> {'cam_loss'}."""
    return _cam_only_step(args, key_index, ('color', 'depth'),
                          'fusion_train_step')


def distill_loss(args, teach_last, last_feat, atten_map):
    """The distillation objective (steps.py:319-348), on NCHW feature maps
    and the NHWC (B, H, W, 1) attention map of the batch.

    -bin_dist replicates the reference literally: the BCE is reduced to a
    scalar mean first (reduction='mean'), which then broadcasts over the
    attention map. Otherwise the per-sample L2 norm of the (optionally
    sigmoid) feature difference under the attention map, with torch.norm's
    ZERO subgradient where the difference is 0 (JAX's double where;
    the value is unchanged)."""
    atten = torch.as_tensor(atten_map).permute(0, 3, 1, 2)
    batch = last_feat.shape[0]
    if args.bin_dist:
        bce = losses.bce_with_logits(last_feat,
                                     torch.sigmoid(teach_last)).mean()
        diff = bce * atten
        return diff.reshape(batch, -1).sum(-1).mean()
    if args.sigmoid:
        diff = torch.sigmoid(teach_last) - torch.sigmoid(last_feat)
    else:
        diff = teach_last - last_feat
    diff = diff * atten
    sq = torch.square(diff.reshape(batch, -1)).sum(-1)
    positive = sq > 0
    norm = torch.sqrt(torch.where(positive, sq, torch.ones_like(sq)))
    return torch.where(positive, norm, torch.zeros_like(norm)).mean()


def make_distill_train_step(args, key_index, teacher_is_fusion, with_semi):
    """distill_train (steps.py:351-428): the teacher's forward under
    no_grad, the distillation on the last feature maps weighted by alpha,
    and the optional semi-supervised batch folded into the same update.

    Without -do_freeze both networks run train-mode BN: the teacher
    normalises with batch statistics and its running statistics drift in
    place (JAX threads the drifted teacher_vars back to the caller; here
    they stay in the teacher module the caller holds). With -do_freeze
    both run eval-mode BN and no statistic moves. The student reads the
    batch's 'color'. step(state, teacher, batch, lr, alpha, semi_batch=None)
    -> {'cam_loss', 'dist_loss', 'semi_loss'}."""
    criterion = losses.get_criterion(args.criterion)
    bn_train = not args.do_freeze

    def teacher_forward(teacher, batch, dtype):
        if teacher_is_fusion:
            inputs = (batch['color'], batch['depth'])
        else:
            inputs = ((batch['depth'],) if args.depth_only
                      else (batch['color'],))
        with torch.no_grad():
            return _apply(teacher, tuple(map(image_input, inputs)), bn_train,
                          dtype)

    def step(state, teacher, batch, lr, alpha, semi_batch=None):
        dtype = compute_dtype(args, state.model)
        _, teach_last = teacher_forward(teacher, batch, dtype)
        if with_semi:
            _, s_teach_last = teacher_forward(teacher, semi_batch, dtype)
        cam_feat, last_feat = _apply(
            state.model, (image_input(batch['color']),), bn_train, dtype)
        d_loss = distill_loss(args, teach_last, last_feat,
                              batch['atten_map'])
        _, _, c_loss = _decode_loss(args, key_index, criterion, cam_feat,
                                    batch)
        loss = d_loss * alpha + c_loss
        s_loss = torch.zeros((), dtype=loss.dtype, device=loss.device)
        if with_semi:
            _, s_last = _apply(state.model,
                               (image_input(semi_batch['color']),), bn_train,
                               dtype)
            s_loss = distill_loss(args, s_teach_last, s_last,
                                  semi_batch['atten_map'])
            loss = loss + s_loss * alpha
        _update(state, loss, lr)
        return {'cam_loss': c_loss.detach(), 'dist_loss': d_loss.detach(),
                'semi_loss': s_loss.detach()}

    return _named('distill_train_step', step)


def make_depth_eval_step(args, key_index, fusion):
    """vanilla_test / fusion_test forward + decode with BN in eval mode
    (steps.py:431-453). step(state, batch) -> {'spec_cam', 'relat_cam',
    'cam_loss', 'last_feat'}."""
    criterion = losses.get_criterion(args.criterion)

    @torch.no_grad()
    def step(state, batch):
        inputs = ((batch['color'], batch['depth']) if fusion
                  else (batch['in_image'],))
        cam_feat, last_feat = _apply(state.model,
                                     tuple(map(image_input, inputs)), False,
                                     compute_dtype(args, state.model))
        relat, spec, loss = _decode_loss(args, key_index, criterion,
                                         cam_feat, batch)
        return {'spec_cam': spec, 'relat_cam': relat, 'cam_loss': loss,
                'last_feat': last_feat}

    return step
