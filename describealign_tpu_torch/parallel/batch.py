"""Batch and multi-device execution of the device side of the alignment,
the port of describealign_tpu/parallel/batch.py.

The reference aligns a directory's pairs in a sequential Python loop
(describealign.py:1077). Here the pairs are a batch:

- device_align_step: one pair's device side (preprocess, the single-shot
  matcher, the u8 quality transport);
- batched_match: device_align_step over same-bucket pairs on one device;
- sharded_match: the pairs spread over a list of devices, one pair per
  device (pure data parallelism, no cross-pair communication);
- make_mesh: the list of CUDA devices.

The JAX package's mesh is a jax.sharding.Mesh driven by one process; the
port's is a sequence of torch devices, driven by one process too. Pairs are
length-bucketed by the caller (every pair of a batch shares its padded
width); true lengths ride along per pair.
"""
import contextlib

import torch

from ..alignment.matching import (_match_core, _qual_dequantize_f16,
                                  _qual_quantize_u8)
from ..alignment.preprocess import preprocess_features
from ..utils import spans


def make_mesh(n_devices=None):
    """The first n_devices CUDA devices (all of them by default), as a
    list of torch.device."""
    devices = [torch.device('cuda', i)
               for i in range(torch.cuda.device_count())]
    return devices[:n_devices] if n_devices else devices


def device_align_step(feats_a, len_a, feats_v, len_v):
    """The device side of one pair: preprocess + match, on the features'
    device.

    feats_*: (5, Npad) stacked raw features (f16 uploads welcome: cast to
    f32 here, like the single-pair entry points); len_*: true frame counts.
    Returns the compressed candidate form (quals f16 (B, 210, K), offs
    int16, starts int32) and the coarse-confidence margin (f32 scalar) that
    the host stages take (video frame = starts[b] + off). The qualities
    ride the u8 transport grid of the single-pair paths, so sharded and
    serial results agree."""
    with spans.span('match'):
        feats_a = feats_a.float()
        feats_v = feats_v.float()
        ms_a, norms_a = preprocess_features(feats_a)
        ms_v, norms_v = preprocess_features(feats_v)
        quals, offs, starts, _, margin = _match_core(
            ms_a, norms_a, feats_a[0], int(len_a),
            ms_v, norms_v, feats_v[0], int(len_v))
        return (_qual_dequantize_f16(_qual_quantize_u8(quals)),
                offs.to(torch.int16), starts, margin)


def batched_match(feats_a, lens_a, feats_v, lens_v):
    """device_align_step over the pair axis. feats_*: (B, 5, Npad) on one
    device; lens_*: (B,) true frame counts. Returns the four outputs
    stacked along a leading pair axis.

    A loop over the pairs, not torch.func.vmap (the JAX package vmaps):
    the hand-written kernels have no batching rule. The pairs' launches
    queue on the device with no host wait between them."""
    outs = [device_align_step(fa, la, fv, lv)
            for fa, la, fv, lv in zip(feats_a, lens_a, feats_v, lens_v)]
    return tuple(torch.stack(o) for o in zip(*outs))


def sharded_match(mesh, feats_a, lens_a, feats_v, lens_v):
    """Data-parallel matching over a list of devices: pair j runs
    device_align_step on mesh[j % len(mesh)] (mesh[j] when there are no
    more pairs than devices).

    feats_*: per pair a (5, Npad) tensor (placed on its device here);
    lens_*: per pair true frame counts. Every pair is dispatched before any
    result is read. Returns per pair device_align_step's outputs, on the
    pair's device."""
    out = []
    for j, (fa, la, fv, lv) in enumerate(zip(feats_a, lens_a, feats_v,
                                             lens_v)):
        dev = torch.device(mesh[j % len(mesh)])
        # launches, streams and events are per device
        with (torch.cuda.device(dev) if dev.type == 'cuda'
              else contextlib.nullcontext()):
            out.append(device_align_step(fa.to(dev, non_blocking=True), la,
                                         fv.to(dev, non_blocking=True), lv))
    return out
