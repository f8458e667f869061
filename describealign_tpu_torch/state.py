"""The matcher state carried across from the JAX package.

The system has no weights: what one stage hands the next is the coarse
pass's device state. `state_from_numpy` turns the JAX package's
`matching.match_coarse` output (ms_a, norms_a, a_mask, ms_v, norms_v,
v_mask, starts_tracks, margin), taken as numpy arrays, into the port's
tensors, so the fine half can be run and tested on the JAX coarse output.
"""
import numpy as np
import torch


def state_from_numpy(jax_state, device):
    """(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts_tracks,
    margin) numpy arrays -> the same tuple as port tensors on `device`:
    f32 features and norms, bool masks, i32 (T, B_pad) starts, f32 scalar
    margin."""
    ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts, margin = [
        np.asarray(a) for a in jax_state]

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return (t(ms_a, torch.float32), t(norms_a, torch.float32),
            t(a_mask, torch.bool), t(ms_v, torch.float32),
            t(norms_v, torch.float32), t(v_mask, torch.bool),
            t(starts, torch.int32), t(margin, torch.float32))
