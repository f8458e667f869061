"""describealign-tpu-torch: the PyTorch + CUDA port of describealign_tpu.

Aligns an audio-description track to a video's original soundtrack on an
NVIDIA H100. The module names mirror the JAX package's, so each function's
counterpart is found under the same path in `describealign_tpu/`. The port
imports torch and never jax, and nothing of the JAX package: the host
modules it needs (host features, outputs, pass-2 DP bridge, constants,
synthetic media) and the host C++ sources (csrc/dp.cpp, csrc/features.cpp)
are copied into it, and its own loaders build the host library (g++) and
the CUDA kernels (nvcc) into build/describealign_tpu_torch/.

    from describealign_tpu_torch import align_from_pcm
    x, y, sim, path, slope, margin = align_from_pcm(video_i16, audio_i16,
                                                    device="cuda")
"""
import torch

__version__ = '0.1.0'

# IEEE fp32 everywhere: TF32 keeps 10 mantissa bits, ~1e-3 on a 41-tap
# correlation - the size of the u8 quality grid step (matching.py)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def align_from_pcm(*args, **kwargs):
    """int16 PCM in, alignment out; see alignment.api.align_from_pcm."""
    from .alignment.api import align_from_pcm as _align_from_pcm
    return _align_from_pcm(*args, **kwargs)


def align(*args, **kwargs):
    """Align one feature pair; see alignment.api.align."""
    from .alignment.api import align as _align
    return _align(*args, **kwargs)
