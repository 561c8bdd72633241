"""The training path of the port (pose_tpu/train): losses, the schedules,
the RGB steps (joint/cam train, eval) with the `RgbTrainer` epoch loop,
the depth steps (vanilla, fusion, distill, eval) with `DepthTrainer`, and
the full-state checkpoints of a run (`state_io`).

`default_train_args` is the flagship `cmu_train.sh` flag set and
`default_depth_args` the `ntu_train.sh` one (both without -pretrain, whose
checkpoint is not in the repository), over the root `opts.py` defaults the
steps read, copied here since the port does not import `opts.py`."""

import types

# index of 'BodyCenter' in the CMU-19 skeleton (joint_settings.py,
# datasets.py:29-36): the root every prediction is made relative to
CMU_KEY_INDEX = 2
# index of 'pelv' in the H36M-17 skeleton that depth_main.py uses for the
# NTU/PKU 17-joint subset (datasets.build_info('h36m').key_index)
H36M_KEY_INDEX = 16


def default_train_args(**over):
    """cmu_train.sh: resnet50, stride 16, 257² crops, 19 joints, 16 depth
    bins, -joint_space -do_track -extra_channel -half_acc, SmoothL1, batch
    64, learn rate 2e-5; opts.py defaults for grad_norm (5.0), weight_decay
    (4e-5), n_epochs (20), print_freq (1), depth_range (1000 mm) and the
    metric thresholds (50, 100, 150 mm).
    bn_impl '' reads POSE_TPU_BN (default 'xla'), as the JAX model does."""
    base = dict(model='resnet50', criterion='SmoothL1', half_acc=True,
                extra_channel=True, joint_space=True, do_track=True,
                skip_relu=False, early_dist=False, depth_only=False,
                side_in=257, stride=16, num_joints=19, depth=16,
                depth_range=1000.0, batch_size=64, learn_rate=2e-5,
                grad_norm=5.0, weight_decay=4e-5, n_epochs=20, print_freq=1,
                thresh_solid=50.0, thresh_close=100.0, thresh_rough=150.0,
                bn_impl='')
    base.update(over)
    return types.SimpleNamespace(**base)


def default_depth_args(**over):
    """ntu_train.sh: resnet50, -half_acc, SmoothL1, 17 joints, depth_range
    1e3 mm, loss_div 10, data_name ntu; opts.py defaults for the rest:
    batch 64, 257^2 crops, stride 16, 16 depth bins, learn_rate 5e-5 with
    warmup 1 epoch at factor 0.2 and decay 0.2, alpha 0.1 (init and
    destination, over 10 epochs), grad_norm 5, weight_decay 4e-5, semi
    batch 16, every mode and feature flag off. A teacher's and its
    student's flags differ only in do_fusion, partial_conv and depth_only
    (depth_main.py builds the student from a copy with depth_only off).
    bn_impl '' reads POSE_TPU_BN (default 'xla'), as the JAX model does."""
    base = dict(model='resnet50', criterion='SmoothL1', half_acc=True,
                data_name='ntu', num_joints=17, depth_range=1000.0,
                loss_div=10.0, side_in=257, stride=16, depth=16,
                batch_size=64, semi_batch=16, learn_rate=5e-5, warmup=1,
                warmup_factor=0.2, learn_decay=0.2, alpha_init=0.1,
                alpha_dest=0.1, alpha_span=10, grad_norm=5.0,
                weight_decay=4e-5, n_epochs=20, print_freq=1,
                do_fusion=False, partial_conv=False, depth_only=False,
                do_teach=False, semi_teach=False, do_freeze=False,
                skip_relu=False, early_dist=False, sigmoid=False,
                bin_dist=False, attention=False, nexponent=False,
                to_depth=False, joint_space=False, do_track=False,
                extra_channel=False, bn_impl='')
    base.update(over)
    return types.SimpleNamespace(**base)
