"""The host C++ library of the port: native/dp.cpp + native/features.cpp
(LIS stream, L1 fit cascade, continuity errors, pass-2 refinement, feature
rescale), shared with the JAX package.

Its ctypes loader and lazy g++ build (describealign_tpu/alignment/native.py)
import no jax, so the port shares them by import. Every module of the port
reaches the library through this one name.
"""
from describealign_tpu.alignment.native import native_lib

__all__ = ['native_lib']
