"""Content hashing for report provenance, a copy of
describealign_tpu/utils/hashing.py.

The reference stamps every report with a SHA1[:8] of its single script
(describealign.py:1762-1769). This package is multi-file, so the version
hash is the SHA1 of all of the port's source files (Python, C++ and CUDA),
hashed in sorted-path order. It differs from the JAX package's hash, so an
alignment cache written by one package is never read by the other.
"""
import hashlib
import os

_CACHED = None


def get_version_hash():
    global _CACHED
    if _CACHED is not None:
        return _CACHED
    try:
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        sha = hashlib.sha1()
        for dirpath, dirnames, filenames in sorted(os.walk(pkg_root)):
            dirnames.sort()
            for name in sorted(filenames):
                if not name.endswith(('.py', '.cpp', '.h', '.cu', '.cuh')):
                    continue
                path = os.path.join(dirpath, name)
                sha.update(os.path.relpath(path, pkg_root).encode())
                with open(path, 'rb') as f:
                    sha.update(f.read())
        _CACHED = sha.hexdigest()[:8]
    except Exception:
        _CACHED = "None"
    return _CACHED
