"""describealign-tpu-torch: the PyTorch + CUDA port of describealign_tpu.

Aligns an audio-description track to a video's original soundtrack on an
NVIDIA H100. The module names mirror the JAX package's, so each function's
counterpart is found under the same path in `describealign_tpu/`. The port
imports torch and never jax, and nothing of the JAX package: the host
modules it needs (host features, outputs, pass-2 DP bridge, constants,
synthetic media) and the host C++ sources (csrc/dp.cpp, csrc/features.cpp)
are copied into it, and its own loaders build the host library (g++) and
the CUDA kernels (nvcc) into build/describealign_tpu_torch/.

    from describealign_tpu_torch import (align_batch_from_pcm,
                                         align_from_pcm, combine,
                                         features_for)
    x, y, sim, path, slope, margin = align_from_pcm(video_i16, audio_i16,
                                                    device="cuda")
    results = align_batch_from_pcm([(video_i16, audio_i16), ...])
    # features='device' on either entry point computes the features on
    # the card from the int16 PCM (two hand-written CUDA kernels)
    feats, n_frames = features_for(pcm)             # 5 numpy streams
    # frontend='mel' (host features, features_for) swaps streams 2-4 for
    # mel bands; mesh=[devices] matches a batch data-parallel
    # (parallel/batch.py); parallel/seqshard.py shards long PCM over devices
    combine("video.mp4", "audio.mp3")          # or the CLI:
    # describealign-tpu-torch video.mp4 audio.mp3
"""
import torch

__version__ = '0.1.0'

# IEEE fp32 everywhere: TF32 keeps 10 mantissa bits, ~1e-3 on a 41-tap
# correlation - the size of the u8 quality grid step (matching.py)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def combine(*args, **kwargs):
    """Align and combine media pairs; see pipeline.combine."""
    from .pipeline import combine as _combine
    return _combine(*args, **kwargs)


def align_from_pcm(*args, **kwargs):
    """int16 PCM in, alignment out; see alignment.api.align_from_pcm."""
    from .alignment.api import align_from_pcm as _align_from_pcm
    return _align_from_pcm(*args, **kwargs)


def align(*args, **kwargs):
    """Align one feature pair; see alignment.api.align."""
    from .alignment.api import align as _align
    return _align(*args, **kwargs)


def features_for(*args, **kwargs):
    """PCM in, the 5 feature streams (numpy) and the true frame count out;
    see pipeline.features_for."""
    from .pipeline import features_for as _features_for
    return _features_for(*args, **kwargs)


def align_batch_from_pcm(*args, **kwargs):
    """A list of int16 PCM pairs in, one alignment per pair out; see
    alignment.api.align_batch_from_pcm."""
    from .alignment.api import align_batch_from_pcm as _align_batch
    return _align_batch(*args, **kwargs)
