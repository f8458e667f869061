"""Sequence-parallel feature extraction over a list of devices, the port
of describealign_tpu/parallel/seqshard.py.

For hours-long media the 44.1 kHz PCM is cut along time into one shard per
device, and each device computes the 210 fps features of its shard. Every
feature op is a local convolution or reduction of bounded reach (~2000
samples for the band cascade, ~1500 for the energy smoother), so a halo of
HALO_FRAMES * 210 samples from each neighbour makes every interior frame
the unsharded computation's.

The JAX package runs this as one shard_map program over a mesh axis, the
halos moved by jax.lax.ppermute. JAX drives every chip of a host from one
process, so the port does too: `mesh` is a sequence of torch devices, one
shard each, and the halos are device-to-device copies (peer copies between
GPUs). The same device may stand more than once (one card holding every
shard). Each shard runs the device extractor's two kernels
(ops/features.py: K1 pcm_frontend, K2 polyphase_cascade) on its
halo-extended PCM.

Shard-size contract: each shard is a multiple of 210 samples, so the
polyphase cascade's phases stay globally aligned, and at least a halo long.
"""
import torch

from ..ops import features as F

HALO_FRAMES = 16
HALO = HALO_FRAMES * 210  # samples


def _halo_exchange(shards):
    """Each shard with its neighbours' boundary samples appended: (C, S)
    -> (C, S + 2*HALO), on the shard's device. The edge shards get zeros
    (the unsharded zero-padded 'same' convolution's boundaries). The
    copies are enqueued without a host wait."""
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        zeros = torch.zeros((x.shape[0], HALO), dtype=x.dtype,
                            device=x.device)
        left = (zeros if i == 0 else
                shards[i - 1][:, -HALO:].to(x.device, non_blocking=True))
        right = (zeros if i == n - 1 else
                 shards[i + 1][:, :HALO].to(x.device, non_blocking=True))
        out.append(torch.cat([left, x, right], dim=1))
    return out


def _local_features(ext, s_loc, is_last):
    """One shard's (5, s_loc // 210) features from its halo-extended PCM.
    The last shard's right halo is zeros: the data-to-zero sign crossing
    at sample HALO + s_loc, which the unsharded computation never sees, is
    cancelled (zero_crossing_feature's kill_crossing_at)."""
    f0 = HALO // 210
    f_loc = s_loc // 210
    streams = F.polyphase_cascade(*F.pcm_frontend(
        ext, kill_crossing_at=HALO + s_loc if is_last else None))
    return torch.stack([x[f0:f0 + f_loc] for x in streams])


def _place(x, device):
    """x on device; a host tensor goes to a card through pinned memory, so
    the copy is asynchronous."""
    if device.type == 'cuda' and x.device.type == 'cpu':
        x = x.contiguous().pin_memory()
    return x.to(device, non_blocking=True)


def sequence_sharded_features(pcm, mesh):
    """Extract (5, S//210) f32 features with the PCM cut along time into
    len(mesh) shards, shard i on mesh[i].

    pcm: (C, S) numpy array or tensor, S a multiple of 210 * len(mesh).
    Every shard is dispatched before any result is read; the features are
    gathered on mesh[0]."""
    mesh = [torch.device(d) for d in mesh]
    pcm = torch.as_tensor(pcm).to(dtype=torch.float32)
    n = len(mesh)
    s = pcm.shape[1]
    if n == 0 or s % (210 * n):
        raise ValueError(f"sequence_sharded_features: {s} samples do not "
                         f"split into {n} shards of a multiple of 210")
    s_loc = s // n
    if s_loc < HALO:
        raise ValueError(f"sequence_sharded_features: shards of {s_loc} "
                         f"samples are shorter than the {HALO}-sample halo")
    shards = [_place(pcm[:, i * s_loc:(i + 1) * s_loc], d)
              for i, d in enumerate(mesh)]
    feats = [_local_features(ext, s_loc, i == n - 1)
             for i, ext in enumerate(_halo_exchange(shards))]
    return torch.cat([f.to(mesh[0], non_blocking=True) for f in feats],
                     dim=1)
