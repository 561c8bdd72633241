"""RGB training entry point of the port (the counterpart of the root
main.py): cmu_train.sh's flags run unchanged.

    python -m pose_tpu_torch.main -model resnet50 -suffix run \\
        -data_name cmu -save_path SAVE -criterion SmoothL1 -n_cudas 1 ...

builds the model (`-pretrain`: a torchvision-key state dict at
-model_path, through the extra-channel surgery), the valid and train
`PoseLoader`s of the store that -metadata_path names, the `RgbTrainer`
and the `Logger`; then trains -n_epochs epochs, each followed by a test
epoch and a checkpoint (`model_<E>.pth`, `best.pth`, `train_record.pth`
under -save_record). -val_only / -test_only reload the best epoch's
checkpoint and run one test epoch; -resume continues from -model_path.

-save_state also writes the run's full state after each epoch
(`train/state_io.py`: Adam's moments, the BN statistics, the loader's
epoch) and `-resume -save_state` restores it, so the resumed run equals
the uninterrupted one bit for bit; -save_every N adds a mid-epoch snapshot
every N steps, from which `-resume` continues the interrupted epoch.
-trace_dir writes a torch.profiler trace of the first trained epoch (of
the test epoch under -val_only / -test_only).

Device: CUDA unless -n_cudas 0 (the CPU); `main(argv, device=...)` takes
an explicit device (the tests pass 'cpu'). BatchNorm follows POSE_TPU_BN
('pallas': the fused kernels; default 'xla'), as in JAX. Flags of parts
not ported yet raise NotImplementedError naming their ROADMAP item.
"""

import os
import sys
import types

import torch

from . import opts, runtime
from .data import joints
from .data.loader import PoseLoader
from .models import build_model, convert, init_weights
from .train import state_io
from .train.engine import RgbTrainer
from .train.logger import Logger
from .utils.profiling import cli_trace

# flag -> (is it set, what is not ported, ROADMAP Queue 1 item)
UNPORTED = (
    ('n_cudas', lambda a: a.n_cudas > 1, 'more than one device', 4),
    ('mesh_spatial', lambda a: a.mesh_spatial > 1, 'the spatial mesh', 4),
    ('dist_coord', lambda a: a.dist_coord, 'multi-host training', 4),
)


def check_ported(args):
    """Raise NotImplementedError for a flag whose part is not ported."""
    for flag, is_set, what, item in UNPORTED:
        if is_set(args):
            raise NotImplementedError(
                f'-{flag}: {what} is not ported yet (ROADMAP Queue 1 item '
                f'{item})')


def create_variables(args, model):
    """Warm start and checkpoint reload (root main.py:19-61) into the
    trainer's model, in place. Returns the logger state of -resume."""
    assert not (args.resume and args.pretrain)
    assert args.model in ('resnet18', 'resnet50')
    state = None
    if args.pretrain:
        convert.load_pretrained(model, args, 'rgb')
    if args.test_only or args.val_only:
        save_path = os.path.join(args.save_path,
                                 args.model + '-' + args.suffix)
        print('=> Loading checkpoint from '
              + os.path.join(save_path, 'best.pth'))
        assert os.path.exists(save_path)
        best = convert.load_torch_file(os.path.join(save_path,
                                                    'best.pth'))['best']
        checkpoint = convert.load_torch_file(
            os.path.join(save_path, 'model_%d.pth' % best))['model']
        convert.load_state(model, checkpoint)
    if args.resume:
        print('=> Loading checkpoint from ' + args.model_path)
        checkpoint = convert.load_torch_file(args.model_path)
        convert.load_state(model, checkpoint['model'], verbose=False)
        state = checkpoint['state']
    return state


def run_epochs(run, data_loader, test_loader):
    """The training loop of both CLIs (main.py:102-116): -resume -save_state
    -save_every first looks for the interrupted epoch's snapshot; the first
    trained epoch runs under -trace_dir's trace; after each epoch's record
    the -save_state sidecar."""
    args, trainer, logger = run.args, run.trainer, run.logger
    start_epoch = logger.state['epoch'] + 1
    if args.resume and args.save_state and args.save_every:
        trainer._mid_resume_pending = True
    for epoch in range(start_epoch, args.n_epochs + 1):
        with cli_trace(args, capture=epoch == start_epoch) as traced:
            run.train.append(trainer.train(epoch, data_loader))
        if traced is not None:
            run.traces.append(traced.path)
        run.test.append(trainer.test(epoch, test_loader))
        logger.record(epoch, dict(run.train[-1]), run.test[-1],
                      trainer.model)
        state_io.maybe_save_sidecar(trainer, args, epoch, data_loader,
                                    logger)
    logger.final_print()


def run_test(run, test_loader):
    """-val_only / -test_only: one test epoch, under -trace_dir's trace."""
    with cli_trace(run.args) as traced:
        run.test.append(run.trainer.test(0, test_loader))
    if traced is not None:
        run.traces.append(traced.path)


def main(argv=None, device=None):
    """Run the CLI on `argv` (sys.argv[1:] by default). Returns the run:
    its trainer, logger, loaders and records."""
    args = opts.parse(argv)
    assert args.do_track <= args.joint_space
    check_ported(args)
    if device is None:
        device = 'cpu' if args.n_cudas == 0 else 'cuda'
    device = runtime.resolve_device(device)

    model = init_weights(build_model(args, 'rgb'),
                         torch.Generator().manual_seed(0))
    data_info = joints.build_info(args.data_name)
    data_loader = None
    if args.test_only:
        test_loader = PoseLoader(args, 'test', data_info, device=device)
    else:
        test_loader = PoseLoader(args, 'valid', data_info, device=device)
        if not args.val_only:
            data_loader = PoseLoader(args, 'train', data_info,
                                     device=device)
    print('=> Dataloaders are ready')

    trainer = RgbTrainer(args, model, data_info, device=device)
    state = create_variables(args, trainer.model)
    if args.resume and not (args.test_only or args.val_only):
        state = state_io.maybe_restore_sidecar(
            trainer, args, state['epoch'], data_loader) or state
    print('=> Model and criterion are ready')

    logger = Logger(args, state)
    print('=> Logger is ready')
    print('=> Trainer is ready')

    run = types.SimpleNamespace(args=args, trainer=trainer, logger=logger,
                                train_loader=data_loader,
                                test_loader=test_loader, train=[], test=[],
                                traces=[])
    if args.test_only or args.val_only:
        run_test(run, test_loader)
        return run
    print('=> Start training')
    run_epochs(run, data_loader, test_loader)
    return run


if __name__ == '__main__':
    main(sys.argv[1:])
