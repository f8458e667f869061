"""Build and load the port's compiled libraries: nvcc (the CUDA kernels)
and g++ (the host C++ library) into shared libraries with a plain C
interface, loaded with ctypes.

Each library is compiled at first use into build/describealign_tpu_torch/
under the checkout (a directory .gitignore lists) and rebuilt when the
hash of its sources, compiler command and salt changes. The compile
happens on the machine that runs the code: nothing here runs at import
time. A failed build raises with the compiler's stderr.
"""
import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build',
                         'describealign_tpu_torch')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']
# -march=native is safe because the library is built on the machine that
# runs it; the host fingerprint in the stamp rebuilds it on another CPU
GXX_FLAGS = ['-O3', '-march=native', '-shared', '-fPIC', '-std=c++17']

_LOCKS = {}                     # one per library: builds run in parallel
_LOCKS_GUARD = threading.Lock()


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _host_fingerprint():
    """Identifies the CPU a -march=native library was built for."""
    ident = platform.machine()
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith(('flags', 'Features')):
                    ident += line
                    break
    except OSError:
        ident += platform.processor()
    return hashlib.sha1(ident.encode()).hexdigest()[:16]


def _build(name, sources, cmd, salt=''):
    """Path of lib<name>.so built by `cmd + ['-o', out] + sources`,
    compiling it if it is missing or its stamp differs. Concurrent builders
    each write a private file and rename it into place."""
    srcs = [os.path.join(CSRC, s) for s in sources]
    digest = hashlib.sha256((' '.join(cmd[1:]) + salt).encode())
    for s in srcs:
        with open(s, 'rb') as f:
            digest.update(f.read())
    digest = digest.hexdigest()
    out = os.path.join(BUILD_DIR, f'lib{name}.so')
    stamp = out + '.sha256'
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        try:
            with open(stamp) as f:
                if f.read() == digest and os.path.exists(out):
                    return out
        except OSError:
            pass
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{out}.{os.getpid()}.tmp'
        proc = subprocess.run(cmd + ['-o', tmp] + srcs, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed for "
                               f"{name}:\n{proc.stderr}")
        os.replace(tmp, out)
        with open(stamp, 'w') as f:
            f.write(digest)
    return out


def build_library(name, sources):
    """lib<name>.so from the CUDA sources csrc/<sources> (nvcc, sm_90a)."""
    return _build(name, sources, [_nvcc()] + NVCC_FLAGS)


def build_host_library(name, sources):
    """lib<name>.so from the C++ sources csrc/<sources> (g++), rebuilt
    when the host CPU changes."""
    return _build(name, sources, ['g++'] + GXX_FLAGS,
                  salt=_host_fingerprint())


def load_library(name, sources):
    return ctypes.CDLL(build_library(name, sources))
