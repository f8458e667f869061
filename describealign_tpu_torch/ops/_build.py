"""Build and load the port's CUDA kernels: nvcc into a shared library with
a plain C interface, loaded with ctypes.

Each library is compiled at first use into build/describealign_tpu_torch/
under the checkout (a directory .gitignore lists) and rebuilt when the
hash of its sources and flags changes. The compile happens on the machine
with the card: nothing here runs at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build',
                         'describealign_tpu_torch')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_LOCK = threading.Lock()


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def build_library(name, sources):
    """Path of lib<name>.so built from csrc/<sources>, compiling it if it is
    missing or its source hash changed. Concurrent builders each write a
    private file and rename it into place."""
    srcs = [os.path.join(CSRC, s) for s in sources]
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, 'rb') as f:
            digest.update(f.read())
    digest = digest.hexdigest()
    out = os.path.join(BUILD_DIR, f'lib{name}.so')
    stamp = out + '.sha256'
    with _LOCK:
        try:
            with open(stamp) as f:
                if f.read() == digest and os.path.exists(out):
                    return out
        except OSError:
            pass
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{out}.{os.getpid()}.tmp'
        proc = subprocess.run([_nvcc()] + NVCC_FLAGS + ['-o', tmp] + srcs,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        os.replace(tmp, out)
        with open(stamp, 'w') as f:
            f.write(digest)
    return out


def load_library(name, sources):
    return ctypes.CDLL(build_library(name, sources))
