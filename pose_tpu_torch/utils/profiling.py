"""Profiler hooks (port of pose_tpu/utils/profiling.py, on torch.profiler
in place of jax.profiler).

- `trace(log_dir)`: a torch.profiler capture of the wrapped block, CPU
  activity and, where CUDA is available, the card's kernels and copies;
  at its end a Chrome trace (`<host>.<pid>.<ms>.pt.trace.json`, which
  chrome://tracing, Perfetto and TensorBoard's profiler read) is written
  into `log_dir` and its path left in the handle's `path`;
- `annotate(name)`: a named range in the trace (record_function);
- `StepTimer`: images a second over windows of steps, waiting for the
  card only at a window's edges (a CUDA event);
- `cli_trace(args, capture)`: the `-trace_dir` flag's context.
"""

import contextlib
import os
import socket
import time

import torch


class TraceHandle:
    """What `trace` yields: the profiler and, once the block ends, the
    written trace's path."""

    def __init__(self, profiler):
        self.profiler = profiler
        self.path = None


@contextlib.contextmanager
def trace(log_dir):
    """Capture a torch.profiler trace of the block into `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        handle = TraceHandle(prof)
        yield handle
    handle.path = os.path.join(log_dir, '%s.%d.%d.pt.trace.json' % (
        socket.gethostname(), os.getpid(), int(time.time() * 1e3)))
    prof.export_chrome_trace(handle.path)


def annotate(name):
    """A named range of the profiler's timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock images a second over windows of `window` steps. It waits
    for the card (a CUDA event on the current stream) at a window's first
    and last step only, so the steps between stay asynchronous."""

    def __init__(self, window=20, device=None):
        self.window = window
        self.device = torch.device(device) if device is not None else None
        self._count = 0
        self._images = 0
        self._t0 = None
        self.images_per_sec = None

    def _sync(self):
        if self.device is not None and self.device.type == 'cuda':
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            event.synchronize()

    def update(self, batch_size):
        if self._t0 is None:
            self._sync()
            self._t0 = time.perf_counter()
            self._count = 0
            self._images = 0
            return self.images_per_sec
        self._count += 1
        self._images += batch_size
        if self._count >= self.window:
            self._sync()
            dt = time.perf_counter() - self._t0
            self.images_per_sec = self._images / dt
            self._t0 = time.perf_counter()
            self._count = 0
            self._images = 0
        return self.images_per_sec


def cli_trace(args, capture=True):
    """The -trace_dir flag: a trace of the wrapped block when `capture` and
    the flag is set, else a no-op."""
    trace_dir = getattr(args, 'trace_dir', None)
    if capture and trace_dir:
        print('=> Capturing profiler trace to ' + trace_dir)
        return trace(trace_dir)
    return contextlib.nullcontext()
