"""Seeded starting weights, made on the device in two large draws: every
trunk convolution He-normal on fan_out from one normal draw, the heads
torch Conv2d's uniform(+-1/sqrt(fan_in)) from one uniform draw, BN at
weight 1 (the last BN of each residual branch at RESIDUAL_BN_SCALE),
bias 0 and running statistics (0, 1). Names and shapes follow
the bottleneck PoseResNet's torch keys, worked out from the configuration
alone, so the program (a strict load) and the reference get the same
tensors from the same seed."""

import math

import torch

from . import work

HEADS = ('cam_regressor', 'mat_regressor', 'regressor')
# The scale of each bottleneck's last BN (bn3) at the start, as in the
# zero-init-residual recipe (Goyal et al. 2017, torchvision's
# zero_init_residual) but not zero, so every layer still takes part: at
# scale 1 a BN ResNet-50 at He init is chaotic in its backward, and float32
# against float32 in another summation order already parts by ~1.5 % in
# the first gradient, which leaves no room between the program's bfloat16
# and a lower precision (PERF.md gives the readings).
RESIDUAL_BN_SCALE = 0.2


def weight_shapes(m):
    """{name: shape} of the model `m` (work.model_layers' dict): conv
    weights (cout, cin, k, k), head biases (cout,), BN vectors (c,) for
    '.weight', '.bias', '.running_mean', '.running_var' and a ()
    '.num_batches_tracked'."""
    shapes = {}
    s2, s3, s4, _, _, _ = work.stage_schedule(m['stride'])

    def conv(name, cin, cout, k, bias=False):
        shapes[name + '.weight'] = (cout, cin, k, k)
        if bias:
            shapes[name + '.bias'] = (cout,)

    def bn(name, c):
        for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
            shapes[f'{name}.{leaf}'] = (c,)
        shapes[name + '.num_batches_tracked'] = ()

    def stage(name, cin, planes, blocks, stride):
        for i in range(blocks):
            pre = f'{name}.{i}'
            conv(pre + '.conv1', cin, planes, 1)
            bn(pre + '.bn1', planes)
            conv(pre + '.conv2', planes, planes, 3)
            bn(pre + '.bn2', planes)
            conv(pre + '.conv3', planes, planes * 4, 1)
            bn(pre + '.bn3', planes * 4)
            if i == 0 and ((stride if i == 0 else 1) != 1
                           or cin != planes * 4):
                conv(pre + '.downsample.0', cin, planes * 4, 1)
                bn(pre + '.downsample.1', planes * 4)
            cin = planes * 4
        return cin

    layers = m['layers']
    conv('conv1', m['in_channels'], 64, 7)
    bn('bn1', 64)
    if m['variant'] == 'fusion':
        conv('conv2', 1, 64, 7)
        bn('bn2', 64)
    c = stage('layer1', 64, 64, layers[0], 1)
    c = stage('layer2', c, 128, layers[1], s2)
    if m['variant'] == 'fusion':
        stage('layer5', 64, 64, layers[0], 1)
        stage('layer6', 256, 128, layers[1], s2)
        conv('fusion.conv', 2 * c, c, 1)
        bn('fusion.bn', c)
    c = stage('layer3', c, 256, layers[2], s3)
    c = stage('layer4', c, 512, layers[3], s4)
    out = m['depth'] * m['num_joints']
    if m['variant'] == 'rgb':
        conv('cam_regressor', c, out, 3, bias=True)
        if m.get('joint_space'):
            conv('mat_regressor', c, m['num_joints'], 3, bias=True)
    else:
        conv('regressor', c, out, 3, bias=True)
    return shapes


def _is_head(name):
    return name.split('.')[0] in HEADS


def make_weights(m, seed, device):
    """{name: f32 tensor} on `device` from `seed` (see the module)."""
    shapes = weight_shapes(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = [n for n, s in shapes.items() if len(s) == 4 and not _is_head(n)]
    heads = [n for n, s in shapes.items() if _is_head(n)]
    numel = {n: math.prod(shapes[n]) for n in shapes}
    normal = torch.randn(sum(numel[n] for n in convs), generator=gen,
                         device=device)
    uniform = torch.rand(sum(numel[n] for n in heads), generator=gen,
                         device=device) * 2.0 - 1.0
    out, at = {}, 0
    for n in convs:
        cout, _, kh, kw = shapes[n]
        std = math.sqrt(2.0 / (kh * kw * cout))
        out[n] = (normal[at:at + numel[n]] * std).reshape(shapes[n])
        at += numel[n]
    at = 0
    for n in heads:
        prefix = n.rsplit('.', 1)[0]
        _, cin, kh, kw = shapes[prefix + '.weight']
        bound = math.sqrt(1.0 / (cin * kh * kw))
        out[n] = (uniform[at:at + numel[n]] * bound).reshape(shapes[n])
        at += numel[n]
    for n, s in shapes.items():
        if n in out:
            continue
        leaf = n.rsplit('.', 1)[1]
        if leaf == 'num_batches_tracked':
            out[n] = torch.zeros((), dtype=torch.long, device=device)
        elif leaf == 'weight' and n.endswith('bn3.weight'):
            out[n] = torch.full(s, RESIDUAL_BN_SCALE, device=device)
        elif leaf in ('weight', 'running_var'):
            out[n] = torch.ones(s, device=device)
        else:
            out[n] = torch.zeros(s, device=device)
    return out


def trainable(weights):
    """The names of the leaves an optimizer moves, in `weights`' order."""
    return [n for n in weights
            if not n.endswith(('running_mean', 'running_var',
                               'num_batches_tracked'))]
