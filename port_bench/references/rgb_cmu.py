"""Plain reference of `rgb_cmu`: the cmu_train.sh joint + track step and
the serve.default_args forward, from the configuration, the seed's
weights and the mix's raw inputs (port_bench.plain; float32, TF32 off).

Train step (joint_space with do_track after the first epoch): the colour
input (warp, clip, colour chain, normalise, bbox mask), the trunk with
train-mode BN, both heads, the planar soft-argmax to pixels, the
volumetric one to root-relative millimetres, the SmoothL1 losses masked
by the valid joints, loss = 0.5 (cam + mat) + recon (the least-squares
root's absolute joints against the truth), then clip-decay-Adam."""

import torch

from port_bench import plain


def learn_rate(cfg, epoch):
    """1 / 0.2 / 0.04 of the base rate at 60 % / 90 % of the epochs,
    halved under do_track from epoch 2."""
    a = cfg['train_args']
    lr = a['learn_rate']
    if epoch - 1 >= a['n_epochs'] * 0.9:
        lr *= 0.04
    elif epoch - 1 >= a['n_epochs'] * 0.6:
        lr *= 0.2
    if a['do_track'] and epoch != 1:
        lr /= 2
    return lr


def roles():
    """The models whose weights the seed makes, trained first."""
    return ('train',)


def train_loss(cfg, params, it, epoch, q=None, rows=None):
    """The step's losses on one batch `it` (its first `rows` rows):
    {'cam_loss', 'mat_loss', 'recon_loss'} and the total."""
    a, m = cfg['train_args'], cfg['models']['train']
    p = params['train']
    sl = slice(None, rows)
    x = plain.colour_input(it['canvases'][sl], it['homs'][sl],
                           it['extents'][sl], it['colour'][sl],
                           it['quads'][sl], m['side'], a['extra_channel'])
    n = plain.trunk(p, m, x.permute(0, 3, 1, 2).contiguous(), q=q,
                    ckpt=True)
    cam, mat = plain.heads(p, m, n, q)
    valid = it['true_val'][sl]
    true_cam, key = it['true_cam'][sl], cfg['key_index']
    spec_mat = plain.decode2d(mat, m['num_joints'], m['side'])
    mat_loss = plain.masked_mean(spec_mat, it['true_mat'][sl], valid)
    relat = plain.relative_cam(cam, m, a['depth_range'], key)
    cam_loss = plain.masked_mean(relat + true_cam[:, key:key + 1], true_cam,
                                 valid)
    loss = cam_loss + mat_loss
    recon_loss = torch.zeros_like(loss)
    if a['do_track'] and epoch != 1:
        recon = plain.recon_root(spec_mat, relat, it['intrinsics'][sl])
        recon_loss = plain.masked_mean(recon, true_cam, valid)
        loss = loss * 0.5 + recon_loss
    return dict(cam_loss=cam_loss, mat_loss=mat_loss,
                recon_loss=recon_loss), loss


@torch.no_grad()
def serve_answers(cfg, p, crops, q=None):
    """The served forward on NHWC normalised crops, eval-mode BN:
    relat_cam relative to joint 0 (mm) and spec_mat (px)."""
    m = cfg['models']['serve']
    n = plain.trunk(p, m, crops.permute(0, 3, 1, 2).contiguous(),
                    train=False, q=q)
    cam, mat = plain.heads(p, m, n, q)
    return dict(relat_cam=plain.relative_cam(
                    cam, m, cfg['serve_args']['depth_range'], 0),
                spec_mat=plain.decode2d(mat, m['num_joints'], m['side']))
