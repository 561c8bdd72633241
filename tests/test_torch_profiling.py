"""The profiler hooks of pose_tpu_torch on the CPU (utils/profiling.py, the
`-trace_dir` flag): the depth CLI with -trace_dir -save_state -save_every 1
writes a Chrome trace of its first trained epoch holding each train
step's named ranges and the full-state sidecar; `trace`, `annotate`,
`cli_trace` and `StepTimer` on their own."""

import json
import os
import types

import pytest
import torch

from pose_tpu.data import synthetic as jsynthetic

from pose_tpu_torch import depth_main, main as cli
from pose_tpu_torch.train import state_io
from pose_tpu_torch.utils import profiling


def trace_events(path):
    with open(path) as file:
        return json.load(file)['traceEvents']


def annotations(events):
    return [e['name'] for e in events if e.get('cat') == 'user_annotation']


def test_depth_cli_traces_its_first_epoch_and_saves_its_state(
        tmp_path, monkeypatch, capsys):
    """depth_main -do_fusion (ntu_train.sh's flags at a small size, 2 train
    steps) with -trace_dir -save_state -save_every 1: one trace, of the
    trained epoch, with a fusion_train_step range per step and its
    backward and optimizer ranges inside, and the operators' own events;
    full_state/epoch_1.pt written and the mid-epoch snapshots, one a step,
    cleared once the epoch was recorded."""
    monkeypatch.setenv('POSE_TPU_WARP', 'gather')
    meta = jsynthetic.make_ntu_fixture(str(tmp_path / 'ntu'), num_train=8,
                                       num_valid=4)
    save, trace_dir = str(tmp_path / 'save'), str(tmp_path / 'trace')
    run = depth_main.main(
        ['-shuffle', '-model', 'resnet18', '-suffix', 't', '-data_name',
         'ntu', '-save_path', save, '-criterion', 'SmoothL1', '-num_joints',
         '17', '-depth_range', '1e3', '-loss_div', '1e1', '-n_cudas', '0',
         '-metadata_path', meta, '-batch_size', '4', '-side_in', '65',
         '-stride', '32', '-depth', '4', '-workers', '2', '-n_epochs', '1',
         '-do_fusion', '-save_record', '-trace_dir', trace_dir,
         '-save_state', '-save_every', '1'], device='cpu')
    assert '=> Capturing profiler trace to ' + trace_dir in (
        capsys.readouterr().out)
    assert len(run.traces) == 1
    assert os.path.dirname(run.traces[0]) == trace_dir
    assert os.listdir(trace_dir) == [os.path.basename(run.traces[0])]
    events = trace_events(run.traces[0])
    names = annotations(events)
    assert names.count('fusion_train_step') == 2
    assert names.count('backward') == 2 and names.count('optimizer') == 2
    assert any(e.get('name') == 'aten::convolution' for e in events)

    sidecar = os.path.join(save, 'resnet18-t', state_io.SIDECAR)
    assert os.listdir(sidecar) == ['epoch_1.pt']
    assert len(run.trainer.snapshot_log) == 2
    saved = state_io.read_file(os.path.join(sidecar, 'epoch_1.pt'))
    assert saved['state']['count'] == saved['state']['step'] == 2
    assert saved['loader_epoch'] == 1 and saved['logger']['epoch'] == 1


def test_val_only_traces_the_test_epoch(tmp_path):
    """Under -val_only / -test_only the CLIs trace the test epoch."""
    def test(epoch, batches):
        with profiling.annotate('test_epoch'):
            return {'loss': float(torch.ones(3).sum())}

    run = types.SimpleNamespace(
        args=types.SimpleNamespace(trace_dir=str(tmp_path)),
        trainer=types.SimpleNamespace(test=test), test=[], traces=[])
    cli.run_test(run, None)
    assert run.test == [{'loss': 3.0}] and len(run.traces) == 1
    assert annotations(trace_events(run.traces[0])) == ['test_epoch']


def test_trace_and_annotate(tmp_path):
    """trace() writes a Chrome trace into its directory once the block
    ends; annotate() names a range of it; the operators inside are
    recorded."""
    with profiling.trace(str(tmp_path / 'd')) as handle:
        assert handle.path is None
        with profiling.annotate('outer'):
            torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    assert os.path.isfile(handle.path)
    events = trace_events(handle.path)
    assert annotations(events) == ['outer']
    assert any(e.get('name') == 'aten::mm' for e in events)


@pytest.mark.parametrize('trace_dir,capture', [(None, True), ('t', False)])
def test_cli_trace_without_the_flag_or_the_epoch_is_a_no_op(trace_dir,
                                                            capture):
    args = types.SimpleNamespace(trace_dir=trace_dir)
    with profiling.cli_trace(args, capture=capture) as handle:
        assert handle is None


def test_step_timer_waits_only_at_window_edges(monkeypatch):
    """StepTimer over windows of 3 steps: the first update starts the
    clock, the rate appears after the window's third step, and the card
    is waited for at those two updates only."""
    timer = profiling.StepTimer(window=3, device='cpu')
    waits = []
    monkeypatch.setattr(timer, '_sync', lambda: waits.append(1))
    rates = [timer.update(8) for _ in range(4)]
    assert rates[:3] == [None, None, None] and rates[3] > 0
    assert len(waits) == 2
