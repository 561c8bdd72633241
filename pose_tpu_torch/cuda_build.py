"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface, `_build/<name>_<hash>.so` (gitignored), and
loaded with ctypes. The hash covers the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edit rebuilds and an unchanged source
is compiled once. `compile_sources`
starts one nvcc per missing library, all at once, and waits for them;
`load` compiles one source at first use and caches the loaded library;
`check_launch` and `cuda_stream` serve the wrappers that launch its kernels.

Importing this module compiles nothing and needs no GPU.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')
_loaded = {}
ptxas_logs = {}


def find_nvcc():
    for cand in (os.environ.get('NVCC'), shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError('nvcc not found (looked at $NVCC, PATH and '
                       '$CUDA_HOME/bin): the CUDA kernels cannot be built')


def library_path(name):
    """_build/<name>_<hash of source, headers and flags>.so."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith('.cuh'))
    for fname in [f'{name}.cu'] + headers:
        with open(os.path.join(CSRC, fname), 'rb') as f:
            digest.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f'{name}_{digest.hexdigest()[:16]}.so')


def compile_sources(names, verbose=()):
    """Compile every csrc/<name>.cu whose library is missing, one nvcc each,
    all started together. Returns {name: seconds} (0.0 where the library
    was already built). Raises if nvcc is missing or any build fails. The
    sources in `verbose` are built with `-Xptxas -v` (the same code), and
    what nvcc printed is kept in `ptxas_logs[name]`."""
    started, seconds = {}, {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            seconds[name] = 0.0
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{so}.{os.getpid()}.tmp'
        cmd = [find_nvcc(), *NVCC_FLAGS,
               *(('-Xptxas', '-v') if name in verbose else ()), '-o', tmp,
               os.path.join(CSRC, f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started[name] = (proc, cmd, tmp, so, time.perf_counter())
    failed = []
    for name, (proc, cmd, tmp, so, t0) in started.items():
        _, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f'nvcc failed ({proc.returncode}): {" ".join(cmd)}'
                          f'\n{err}')
        else:
            os.replace(tmp, so)
            if name in verbose:
                ptxas_logs[name] = err
    if failed:
        raise RuntimeError('\n'.join(failed))
    return seconds


def load(name):
    """The loaded ctypes library of csrc/<name>.cu, compiled at first use.
    Every source exports `const char* error_string(int)`, typed here."""
    if name not in _loaded:
        compile_sources([name])
        lib = ctypes.CDLL(library_path(name))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def check_launch(lib, err, name):
    """Raise if a launch entry of `lib` returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: '
                           f'{lib.error_string(err).decode()}')


_raw_stream = getattr(torch._C, '_cuda_getCurrentRawStream', None)


def cuda_stream(t):
    """The current CUDA stream of tensor t's device, as a launch argument
    (the raw handle straight from PyTorch's C side where it has one: a
    Stream object costs microseconds of host time a launch)."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream
