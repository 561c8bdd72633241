"""Depth, fusion and distillation entry point of the port (the counterpart
of the root depth_main.py): ntu_train.sh's flags run unchanged.

    python -m pose_tpu_torch.depth_main -model resnet50 -suffix run \\
        -data_name ntu -save_path SAVE -criterion SmoothL1 -n_cudas 1 \\
        -metadata_path STORE/metadata.json [-do_fusion | -depth_only |
        -do_teach -teacher_path T.pth] [-partial_conv] ...

builds the model of the flagged variant (depth_main.py:25-29: 'partial_'
under -partial_conv, then 'fusion' under -do_fusion, else 'depth'; under
-do_teach a depth student that reads colour and a teacher of the flagged
variant loaded from -teacher_path's 'model'), `-pretrain` through
`convert.load_pretrained` (-depth_host: -host_path), the loaders that the
store's metadata.json names ('depth_datasets' -> `depth_data_loader`,
'datasets' -> `data_loader`; -semi_teach adds the PKU train loader of the
same metadata at -semi_batch), the `DepthTrainer` and the `Logger`; then
trains -n_epochs epochs, each followed by a test epoch and a checkpoint.
-val_only / -test_only reload `model_<n_epochs>.pth` (depth_main.py:47-56;
the RGB CLI reloads best.pth) and run one test epoch; -resume continues
from -model_path. -save_state, -save_every and -trace_dir work as in the
RGB CLI (`main.run_epochs`); a distillation's full state also holds the
teacher's BN buffers and the semi stream's position.

Device: CUDA unless -n_cudas 0 (the CPU); `main(argv, device=...)` takes
an explicit device (the tests pass 'cpu'). BatchNorm follows POSE_TPU_BN,
as in JAX. Flags of parts not ported yet raise NotImplementedError naming
their ROADMAP item (`main.check_ported`).
"""

import copy
import os
import sys
import types

import torch

from . import opts, runtime
from .data import joints, loader
from .main import check_ported, run_epochs, run_test
from .models import build_model, convert, init_weights
from .train import state_io
from .train.depth_engine import DepthTrainer, load_metadata
from .train.logger import Logger

# the loader modules metadata.json names (depth_train.py:15-19), as the
# port's factories; the root modules import JAX
LOADERS = {'depth_datasets': loader.depth_data_loader,
           'datasets': loader.data_loader}


def model_variant(args):
    variant = 'fusion' if args.do_fusion else 'depth'
    if args.partial_conv:
        variant = 'partial_' + variant
    return variant


def get_loader(args):
    """The loader factory that metadata.json names for args.data_name."""
    name = load_metadata(args)['loader'][args.data_name]
    if name not in LOADERS:
        raise ValueError(f'metadata.json names the loader {name!r} for '
                         f'{args.data_name}; the port has {sorted(LOADERS)}')
    return LOADERS[name]


def load_checkpoint_into(model, args):
    """-val_only / -test_only: model_<n_epochs>.pth of the save path;
    -resume: -model_path. Returns the logger state of -resume."""
    if args.test_only or args.val_only:
        save_path = os.path.join(args.save_path,
                                 args.model + '-' + args.suffix)
        if not os.path.exists(save_path):
            raise FileNotFoundError(save_path)
        checkpoint = os.path.join(save_path,
                                  'model_{}.pth'.format(args.n_epochs))
        print('=> Loads checkpoint from ' + checkpoint)
        convert.load_state(model, convert.load_torch_file(checkpoint)['model'],
                           verbose=False)
    state = None
    if args.resume:
        print('=> Loads checkpoint from ' + args.model_path)
        checkpoint = convert.load_torch_file(args.model_path)
        convert.load_state(model, checkpoint['model'], verbose=False)
        state = checkpoint['state']
    return state


def _check_flags(args):
    for a, b in (('resume', 'pretrain'), ('do_fusion', 'depth_only'),
                 ('depth_host', 'depth_only')):
        if getattr(args, a) and getattr(args, b):
            raise ValueError(f'-{a} and -{b} exclude each other')


def main(argv=None, device=None):
    """Run the CLI on `argv` (sys.argv[1:] by default). Returns the run:
    its trainer, logger, loaders and records."""
    args = opts.parse(argv)
    _check_flags(args)
    check_ported(args)
    if device is None:
        device = 'cpu' if args.n_cudas == 0 else 'cuda'
    device = runtime.resolve_device(device)

    data_info = joints.build_info('h36m')
    variant = model_variant(args)
    if args.do_teach:
        # create_pair (depth_main.py:77-108): the student reads colour, so
        # its args drop -depth_only, which shapes the teacher only
        student_args = copy.copy(args)
        student_args.depth_only = False
        student = init_weights(build_model(student_args, 'depth'),
                               torch.Generator().manual_seed(0))
        trainer = DepthTrainer(args, student, data_info, device=device)
        if args.pretrain:
            convert.load_pretrained(trainer.model, student_args, 'depth')
        teacher = init_weights(build_model(args, variant),
                               torch.Generator().manual_seed(1))
        trainer.set_teacher(
            teacher, convert.load_torch_file(args.teacher_path)['model'])
    else:
        model = init_weights(build_model(args, variant),
                             torch.Generator().manual_seed(0))
        trainer = DepthTrainer(args, model, data_info, device=device)
        if args.pretrain:
            convert.load_pretrained(trainer.model, args, variant)
    state = load_checkpoint_into(trainer.model, args)
    print('=> Models are created and filled')

    make_loader = get_loader(args)
    data_loader = None
    if args.test_only:
        test_loader = make_loader(args, 'test', data_info, device=device)
    else:
        test_loader = make_loader(args, 'valid', data_info, device=device)
        if not args.val_only:
            data_loader = make_loader(args, 'train', data_info,
                                      device=device)
    print('=> Dataloaders are ready')

    if args.semi_teach:
        # the reference builds the PKU semi loader from a copy of the
        # namespace (depth_train.py:67-71)
        semi_args = copy.copy(args)
        semi_args.data_name = 'pku'
        semi_args.batch_size = args.semi_batch
        trainer.set_semi_loader(get_loader(semi_args)(
            semi_args, 'train', data_info, device=device))
    if args.resume and not (args.test_only or args.val_only):
        state = state_io.maybe_restore_sidecar(
            trainer, args, state['epoch'], data_loader) or state

    logger = Logger(args, state)
    print('=> Logger is ready')
    print('=> Trainer is ready')

    run = types.SimpleNamespace(args=args, trainer=trainer, logger=logger,
                                train_loader=data_loader,
                                test_loader=test_loader, train=[], test=[],
                                traces=[])
    if args.test_only or args.val_only:
        print('=> Evaluation starts')
        run_test(run, test_loader)
        logger.print_rec(run.test[-1])
        return run
    print('=> Train starts')
    run_epochs(run, data_loader, test_loader)
    return run


if __name__ == '__main__':
    main(sys.argv[1:])
