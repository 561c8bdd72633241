"""Plain reference of `distill_ntu`: the ntu_train.sh distillation step
(-do_teach -do_fusion -attention) from the configuration, the seed's
weights and the mix's raw inputs (port_bench.plain; float32, TF32 off).

The teacher, a fusion ResNet-50 over colour and depth, runs train-mode
BN with no gradient; the student, a ResNet-50 on colour, is trained on
alpha * (the mean over the batch of the L2 norm of the two stage-4
feature maps' difference under the attention map) + the SmoothL1 of its
root-relative joints plus the true root, both sides divided by loss_div,
then clip-decay-Adam. The colour input is warped, clipped and normalised
(no colour chain in this recipe); the depth input is the raw depth
warped in f32 and scaled (no -nexponent, no -to_depth)."""

import numpy as np

from port_bench import plain


def learn_rate(cfg, epoch):
    """The warm-up factor for the first `warmup` epochs, then decay steps
    at epochs 15, 20 and 25."""
    a = cfg['train_args']
    if epoch - 1 < a['warmup']:
        return a['learn_rate'] * a['warmup_factor']
    steps = sum(epoch - 1 >= e for e in (15, 20, 25))
    return a['learn_rate'] * a['learn_decay'] ** steps


def alpha(cfg, epoch):
    a = cfg['train_args']
    alphas = np.linspace(a['alpha_init'], a['alpha_dest'], a['alpha_span'])
    return float(alphas[epoch - 1]) if epoch - 1 < a['alpha_span'] else \
        float(a['alpha_dest'])


def roles():
    return ('train', 'teacher')


def colour_crops(it, side, sl):
    crops = plain.split_warp(it['canvases'][sl], it['homs'][sl],
                             it['extents'][sl], side)
    return plain.normalize(crops.clamp(0.0, 1.0)).permute(0, 2, 3, 1)


def train_loss(cfg, params, it, epoch, q=None, rows=None):
    a, ms = cfg['train_args'], cfg['models']
    side, key = ms['train']['side'], cfg['key_index']
    sl = slice(None, rows)
    colour = colour_crops(it, side, sl).permute(0, 3, 1, 2).contiguous()
    depth = plain.depth_input(it['depth_canvases'][sl],
                              it['depth_homs'][sl], it['depth_extents'][sl],
                              0.1, side).permute(0, 3, 1, 2).contiguous()
    teacher = params['teacher']
    n_t = plain.trunk({k: v.detach() for k, v in teacher.items()},
                      ms['teacher'], colour, depth, q=q).detach()
    n = plain.trunk(params['train'], ms['train'], colour, q=q, ckpt=True)
    cam, tap = plain.heads(params['train'], ms['train'], n, q)
    d_loss = plain.distill_loss(n_t, tap, it['atten_map'][sl])
    true_cam = it['true_cam'][sl]
    relat = plain.relative_cam(cam, ms['train'], a['depth_range'], key)
    div = a['loss_div']
    c_loss = plain.masked_mean((relat + true_cam[:, key:key + 1]) / div,
                               true_cam / div, it['true_val'][sl])
    return dict(cam_loss=c_loss, dist_loss=d_loss), \
        d_loss * alpha(cfg, epoch) + c_loss
