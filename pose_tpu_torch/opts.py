"""Training-option parser of the port: a copy of the root opts.py parser
(flag-compatible with the reference's, opts.py:1-78, so cmu_train.sh's
flags parse unchanged), which the port may not import.

Unlike the root module it parses nothing at import time: call `parse`.
The port's reading of two flags: -n_cudas is the number of CUDA devices
(0 runs on the CPU; more than one is not ported), and -half_acc is the
bf16 compute of `train.steps._apply`. Flags of parts the port does not
have yet raise in `pose_tpu_torch.main` (`check_ported`).
"""

import argparse
import os


def build_parser():
    parser = argparse.ArgumentParser(
        description='Parser for all the training options')

    # bool options
    parser.add_argument('-shuffle', action='store_true', help='reshuffle the sample order every epoch')
    parser.add_argument('-half_acc', action='store_true', help='half-precision compute (bf16)')
    parser.add_argument('-save_record', action='store_true', help='persist the per-epoch train/test record')
    parser.add_argument('-test_only', action='store_true', help='evaluate on the test split and exit')
    parser.add_argument('-val_only', action='store_true', help='evaluate on the validation split and exit')
    parser.add_argument('-pretrain', action='store_true', help='warm-start the trunk from an ImageNet checkpoint')
    parser.add_argument('-depth_host', action='store_true', help='seed the depth branch from a depth-only checkpoint')
    parser.add_argument('-resume', action='store_true', help='continue training from -model_path')
    parser.add_argument('-extra_channel', action='store_true', help='append a bbox-mask input channel')
    parser.add_argument('-joint_space', action='store_true', help='enable the 2D (joint-space) head and losses')
    parser.add_argument('-do_track', action='store_true', help='add the least-squares root-reconstruction loss')
    parser.add_argument('-depth_only', action='store_true', help='train on the depth modality only')
    parser.add_argument('-nexponent', action='store_true', help='encode depth as exp(-d) instead of d/3')
    parser.add_argument('-to_depth', action='store_true', help='apply the ray-length depth correction')
    parser.add_argument('-partial_conv', action='store_true', help='use mask-propagating partial convolutions')
    parser.add_argument('-do_fusion', action='store_true', help='two-stream RGB+depth fusion model')
    parser.add_argument('-do_teach', action='store_true', help='distill a frozen teacher into the student')
    parser.add_argument('-semi_teach', action='store_true', help='add unlabeled semi-supervised distillation batches')
    parser.add_argument('-early_dist', action='store_true', help='distill the stage-3 feature map instead of stage-4')
    parser.add_argument('-skip_relu', action='store_true', help='tap pre-ReLU feature maps for distillation')
    parser.add_argument('-sigmoid', action='store_true', help='squash feature maps with sigmoid before the distillation norm')
    parser.add_argument('-bin_dist', action='store_true', help='pixelwise BCE distillation objective')
    parser.add_argument('-attention', action='store_true', help='weight the distillation target by joint-centered Gaussians')
    parser.add_argument('-save_last', action='store_true', help='dump last-stage features/predictions per batch')
    parser.add_argument('-do_freeze', action='store_true', help='freeze BN of teacher and student during distillation')
    parser.add_argument('-static_filter', action='store_true', help='whether to filter out near-static poses (used by launch scripts)')

    # augmentation options
    parser.add_argument('-geometry', action='store_true', help='random flip/zoom geometry augmentation')
    parser.add_argument('-colour', action='store_true', help='photometric colour augmentation')
    parser.add_argument('-eraser', action='store_true', help='random-erase augmentation')
    parser.add_argument('-occluder', action='store_true', help='synthetic occluder pasting augmentation')

    # required options
    parser.add_argument('-model', required=True, help='backbone (resnet18 | resnet50)')
    parser.add_argument('-model_path', help='ImageNet pre-train or checkpoint path')
    parser.add_argument('-teacher_path', help='frozen-teacher checkpoint path')
    parser.add_argument('-host_path', help='depth-only host checkpoint path')
    parser.add_argument('-suffix', required=True, help='run-name suffix for the save directory')
    parser.add_argument('-data_name', required=True, help='dataset (cmu | h36m | ntu | pku)')
    parser.add_argument('-occ_path', help='occluder sprite bank directory')
    parser.add_argument('-save_path', required=True, help='directory for checkpoints and records')
    parser.add_argument('-criterion', required=True, help='loss criterion name (SmoothL1 | MSE | L1)')

    # data paths used by the launch scripts (absent from the reference opts.py)
    parser.add_argument('-data_root_path', help='root path of the raw dataset')
    parser.add_argument('-data_down_path', help='path of the downscaled sample store')
    parser.add_argument('-metadata_path',
                        default=os.environ.get(
                            'POSE_TPU_METADATA',
                            '/globalwork/liu/metadata.json'),
                        help='machine-local dataset metadata json (roots, '
                             'loaders, thresholds). Default matches the '
                             'reference hard-coded path (datasets.py:42); '
                             'the POSE_TPU_METADATA env var overrides it so '
                             'the unchanged launch scripts (which never '
                             'pass this flag) can target another store')

    # integer options
    parser.add_argument('-warmup', default=1, type=int, help='warmup epochs for the depth-engine LR schedule')
    parser.add_argument('-n_epochs', default=20, type=int, help='total training epochs')
    parser.add_argument('-batch_size', default=64, type=int, help='global batch size')
    parser.add_argument('-semi_batch', default=16, type=int, help='batch size of the unlabeled semi-supervised stream')
    parser.add_argument('-n_cudas', default=2, type=int, help='Number of CUDA devices (0: the CPU; more than 1 is not ported)')
    parser.add_argument('-mesh_spatial', default=1, type=int,
                        help='spatial-partitioning factor: folds the mesh to '
                             '(n_cudas/mesh_spatial) x mesh_spatial '
                             '(data, space) and shards image height over '
                             "'space' (XLA inserts the conv halo exchanges); "
                             '1 = pure data parallelism')
    parser.add_argument('-workers', default=2, type=int, help='Number of host threads decoding samples')
    parser.add_argument('-num_processes', default=6, type=int, help='process-pool size for the offline tools')
    parser.add_argument('-side_in', default=257, type=int, help='network input side (pixels)')
    parser.add_argument('-stride', default=16, type=int, help='output stride of the trunk')
    parser.add_argument('-num_joints', default=19, type=int, help='joint count of the skeleton')
    parser.add_argument('-depth', default=16, type=int, help='z-bins of the volumetric heatmap')
    parser.add_argument('-alpha_span', default=10, type=int, help='epochs over which alpha anneals')
    parser.add_argument('-occ_count', default=100, type=int, help='number of occluder sprites in occ_path')
    parser.add_argument('-print_freq', default=1, type=int,
                        help='print (and host-sync) train losses every N '
                             'batches; 1 matches the reference console, 0 '
                             'disables per-batch prints entirely')
    parser.add_argument('-compile_cache', default=None,
                        help='XLA compilation-cache directory of the JAX '
                             'package; the port compiles no XLA and reads '
                             'it nowhere')
    parser.add_argument('-dist_coord', default=None,
                        help='multi-host scale-out: coordinator host:port '
                             '(process 0 binds it); launches this process '
                             'into a jax.distributed cluster spanning every '
                             "host's chips. Requires -dist_nprocs and "
                             '-dist_rank. Env fallbacks: POSE_TPU_DIST_*')
    parser.add_argument('-dist_nprocs', type=int, default=0,
                        help='total process count of the distributed cluster')
    parser.add_argument('-dist_rank', type=int, default=-1,
                        help='this process\'s rank in [0, dist_nprocs)')
    parser.add_argument('-strict_eval', action='store_true',
                        help='use the cv2-parity gather resampler at eval '
                             'time instead of the two-pass matmul warp, the '
                             "card's default")
    parser.add_argument('-trace_dir', default=None,
                        help='torch.profiler trace (Chrome JSON) of the '
                             'first trained epoch, or of the test epoch '
                             'under -val_only / -test_only')
    parser.add_argument('-save_state', action='store_true',
                        help='also write the full train state (torch.save '
                             'files under <save_path>/<model>-<suffix>/'
                             'full_state) per epoch and restore it on '
                             '-resume, making resume bit-exact incl. Adam '
                             'moments, BN stats and the loader position '
                             '(the reference torch checkpoints only carry '
                             'weights+epoch; beyond-reference extra)')
    parser.add_argument('-save_every', default=0, type=int,
                        help='with -save_state: additionally write a '
                             'preemption-safe MID-epoch sidecar every N '
                             'train steps; -resume then continues '
                             'bit-exactly from the last snapshot — the '
                             'loaders are (seed, epoch, batch-index)-'
                             'deterministic, so the rest of the epoch '
                             'replays exactly, incl. the distillation '
                             'teacher state and the semi stream position. '
                             '0 disables (beyond-reference extra: TPU pods '
                             'preempt; per-epoch resume loses up to an '
                             'epoch)')

    # train options
    parser.add_argument('-warmup_factor', default=0.2, type=float, help='LR multiplier during warmup')
    parser.add_argument('-learn_rate', default=5e-5, type=float, help='base learning rate')
    parser.add_argument('-learn_decay', default=0.2, type=float, help='LR decay factor at schedule steps')
    parser.add_argument('-grad_norm', default=5.0, type=float, help='global gradient-norm clip')
    parser.add_argument('-grad_scaling', default=32.0, type=float, help='loss scaling magnitude (unused under bf16; kept for CLI parity)')
    parser.add_argument('-momentum', default=0.9, type=float, help='momentum (kept for CLI parity)')
    parser.add_argument('-weight_decay', default=4e-5, type=float, help='Adam weight decay (torch-style, pre-moment)')
    parser.add_argument('-box_margin', default=0.6, type=float, help='margin when deriving pseudo-bboxes from 2D coords')
    parser.add_argument('-alpha_dest', default=0.1, type=float, help='final distillation weight alpha')
    parser.add_argument('-alpha_init', default=0.1, type=float, help='initial distillation weight alpha')
    parser.add_argument('-depth_range', default=1000.0, type=float, help='metric range of the volumetric z-axis (mm)')
    parser.add_argument('-random_zoom', default=0.9, type=float, help='lower bound of the random zoom draw')
    parser.add_argument('-loss_div', default=10.0, type=float, help='divisor applied to GT and prediction before the loss')

    # metric thresholds read by the trainer (train.py:47-51; absent from the
    # reference opts.py — defaults follow common 3D-pose conventions, mm)
    parser.add_argument('-thresh_solid', default=50.0, type=float, help='distance threshold for the solid bucket (mm)')
    parser.add_argument('-thresh_close', default=100.0, type=float, help='distance threshold for the close bucket (mm)')
    parser.add_argument('-thresh_rough', default=150.0, type=float, help='distance threshold for PCK/AUC and the jitter bucket (mm)')

    return parser


def parse(argv=None):
    return build_parser().parse_args(argv)
