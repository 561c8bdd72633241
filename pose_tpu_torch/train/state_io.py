"""Full-state checkpoints of a training run (the counterpart of
pose_tpu/train/orbax_io.py, written as `torch.save` files, not orbax).

The reference's `-resume` restores the model weights and the epoch only
(Logger's `model_<E>.pth`); Adam's moments restart from zero. Under
`-save_state` each epoch also writes the whole continuation of the run,
and `-resume -save_state` reads it back, so a resumed run equals the
uninterrupted one bit for bit. `-save_every N` adds a mid-epoch snapshot
every N train steps (`engine.MidEpochSaver`).

A state file is a dict of CPU tensors, ints and plain containers
(`torch.load(..., weights_only=True)` reads it):
- `state`: the TrainState: `model`, the model's state_dict (the f32
  master parameters and the buffers: BN running statistics); `mu`, `nu`
  (lists in `model.parameters()` order) and `count`, ClipDecayAdam's
  moments and step count; `step`, the TrainState's step;
- `extra`: what else the trainer carries from step to step
  (`BaseTrainer.extra_state`: the distillation teacher's BN buffers, the
  semi stream's position);
- `loader_epoch`: the train loader's epoch counter, which draws its order
  and every random number;
- per-epoch files also hold `logger`, the Logger's state after the
  epoch's record (its best epoch: a `model_<E>.pth` holds the state from
  before the epoch's best update);
- mid-epoch snapshots also hold `meters` (each LossMeter's sums and
  total) and `geometry` (`n_batches`, `batch_size` and `seed` of the
  epoch's loader), which a restore checks against the current run.

Layout, beside the torch checkpoints: `<save_path>/<model>-<suffix>/
full_state/epoch_<E>.pt` after each epoch, and `full_state/mid/<id>.pt`
with id = epoch * 10^7 + next batch, of which the 2 newest are kept and
which `maybe_save_sidecar` deletes once the epoch is recorded. Every file
is written to `<name>.tmp` and renamed into place (`os.replace`), so a
kill during a write loses only that file. Mid-epoch files are written by
one background thread after a synchronous copy to the host: the port's
steps update parameters and moments in place, so the copy is taken
before `step_done` returns.
"""

import os
import re
import shutil
import threading
import time

import torch

SIDECAR = 'full_state'
MID_EPOCH_RADIX = 10 ** 7       # mid-epoch id = epoch * radix + next_batch
KEEP_MID = 2
GEOMETRY = ('n_batches', 'batch_size', 'seed')


def to_host(tree):
    """A copy of `tree` with every tensor copied to the CPU (a copy even of
    CPU tensors: the steps update theirs in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def host_train_state(state):
    """The TrainState `state` (steps.TrainState) as host tensors."""
    tx = state.tx
    return dict(model=to_host(state.model.state_dict()), mu=to_host(tx.mu),
                nu=to_host(tx.nu), count=int(tx.count), step=int(state.step))


def load_train_state(state, saved):
    """Copy a host_train_state into `state` in place (the optimizer keeps
    its parameter tensors)."""
    tx = state.tx
    if len(saved['mu']) != len(tx.mu) or len(saved['nu']) != len(tx.nu):
        raise ValueError(f'the saved optimizer holds {len(saved["mu"])} '
                         f'moments, this model {len(tx.mu)}')
    state.model.load_state_dict(saved['model'])
    with torch.no_grad():
        for dst, src in zip(tx.mu + tx.nu, saved['mu'] + saved['nu']):
            dst.copy_(src)
    tx.count = int(saved['count'])
    state.step = int(saved['step'])


def write_file(path, payload):
    """torch.save to `path` by rename: a kill before the rename leaves the
    previous file, if any, as it was."""
    tmp = path + '.tmp'
    with open(tmp, 'wb') as file:
        torch.save(payload, file)
        file.flush()
        os.fsync(file.fileno())
    os.replace(tmp, path)


def read_file(path):
    return torch.load(path, map_location='cpu', weights_only=True)


def extra_payload(extra):
    """The values of an extra-state map (name -> (getter, setter)) as host
    tensors."""
    return to_host({name: get() for name, (get, _) in extra.items()})


def save_train_state(directory, trainer, epoch, loader, logger):
    """The continuation after `epoch` into `directory`/epoch_<E>.pt."""
    os.makedirs(directory, exist_ok=True)
    payload = dict(state=host_train_state(trainer.state),
                   extra=extra_payload(trainer.extra_state()),
                   loader_epoch=int(loader.epoch), logger=dict(logger.state))
    path = os.path.join(directory, 'epoch_%d.pt' % epoch)
    write_file(path, payload)
    return path


def restore_train_state(directory, trainer, epoch, loader):
    """Load epoch_<E>.pt of `directory` into the trainer and the train
    loader's epoch counter; the payload, or None where there is none."""
    path = os.path.join(directory, 'epoch_%d.pt' % epoch)
    if not os.path.exists(path):
        return None
    payload = read_file(path)
    trainer.load_state(payload['state'])
    for name, (_, set_) in trainer.extra_state().items():
        set_(payload['extra'][name])
    loader.set_epoch(payload['loader_epoch'])
    return payload


def sidecar_dir(args):
    """The run's full-state directory, beside its torch checkpoints."""
    return os.path.join(args.save_path, args.model + '-' + args.suffix,
                        SIDECAR)


def maybe_restore_sidecar(trainer, args, epoch, loader):
    """-resume -save_state: the full state saved after `epoch` (the epoch
    of the resumed checkpoint), where the sidecar holds one. Returns its
    Logger state, or None where nothing was restored."""
    if not getattr(args, 'save_state', False):
        return None
    directory = sidecar_dir(args)
    payload = restore_train_state(directory, trainer, epoch, loader)
    if payload is None:
        print('=> No full train state for epoch %d in %s; Adam restarts '
              'from zero' % (epoch, directory))
        return None
    print('=> Restoring full train state from ' + directory)
    return payload['logger']


def maybe_save_sidecar(trainer, args, epoch, loader, logger):
    """-save_state: the continuation after `epoch`; the epoch is recorded,
    so its mid-epoch snapshots are stale and go."""
    if getattr(args, 'save_state', False):
        save_train_state(sidecar_dir(args), trainer, epoch, loader, logger)
        clear_mid_epoch(args)


# ------------------------------------------------------------ mid-epoch


def mid_epoch_dir(args):
    return os.path.join(sidecar_dir(args), 'mid')


def clear_mid_epoch(args):
    shutil.rmtree(mid_epoch_dir(args), ignore_errors=True)


def mid_epoch_id(epoch, next_batch):
    if not 0 <= next_batch < MID_EPOCH_RADIX:
        raise ValueError(f'next batch {next_batch} is outside the mid-epoch '
                         f'id range [0, {MID_EPOCH_RADIX})')
    return epoch * MID_EPOCH_RADIX + next_batch


def _snapshots(directory):
    """The finished snapshots of `directory` as (id, path), oldest first;
    a `.tmp` file (a write that did not end) is none."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        match = re.fullmatch(r'(\d+)\.pt', name)
        if match:
            found.append((int(match.group(1)),
                          os.path.join(directory, name)))
    return sorted(found)


class MidEpochWriter:
    """Writes mid-epoch snapshots on one background thread, one at a time:
    `save` waits for the write before, then starts the next; `close`
    waits for the last and raises its error. Keeps the `keep` newest.
    `log` holds one dict a snapshot: `wait_ms` (the caller waiting for
    the write before) and, once written, `write_ms`."""

    def __init__(self, directory, keep=KEEP_MID):
        self.directory = directory
        self.keep = keep
        self.log = []
        self._thread = None
        self._error = None
        os.makedirs(directory, exist_ok=True)

    def _write(self, payload, snapshot_id, entry):
        try:
            t0 = time.perf_counter()
            write_file(os.path.join(self.directory, '%d.pt' % snapshot_id),
                       payload)
            for _, path in _snapshots(self.directory)[:-self.keep]:
                os.remove(path)
            entry['write_ms'] = (time.perf_counter() - t0) * 1e3
        except BaseException as e:      # raised by the next save or close
            self._error = e

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(self, payload, snapshot_id):
        t0 = time.perf_counter()
        self._join()
        entry = dict(wait_ms=(time.perf_counter() - t0) * 1e3)
        self.log.append(entry)
        self._thread = threading.Thread(
            target=self._write, args=(payload, snapshot_id, entry),
            daemon=True)
        self._thread.start()
        return entry

    def close(self):
        self._join()


def restore_mid_epoch(args, expected_epoch, geometry):
    """(payload, next_batch) of the newest mid-epoch snapshot when it is of
    `expected_epoch`, else None (an older epoch's was recorded since).
    Raises ValueError where the snapshot's loader geometry differs from
    this run's."""
    found = _snapshots(mid_epoch_dir(args))
    if not found:
        return None
    snapshot_id, path = found[-1]
    if snapshot_id // MID_EPOCH_RADIX != expected_epoch:
        return None
    payload = read_file(path)
    for key in GEOMETRY:
        saved, current = payload['geometry'][key], geometry[key]
        if saved != current:
            raise ValueError(f'mid-epoch snapshot {path} was taken with '
                             f'{key} {saved}, this run has {current}: it '
                             f'cannot resume this epoch')
    next_batch = snapshot_id % MID_EPOCH_RADIX
    if next_batch > geometry['n_batches']:
        raise ValueError(f'mid-epoch snapshot {path} resumes at batch '
                         f'{next_batch} of {geometry["n_batches"]}')
    return payload, next_batch
