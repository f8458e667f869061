"""Port parity on the JAX package's eight edge-case structures
(tests/test_reference_parity.py:123-320: skip heavy, a 4.5-min mix with a
2 % rate change, non-integer offsets, low similarity, two music-bed ridge
cases, a skip at the end of a silent span, PAL 25/24 under a music bed).

The JAX results come from tests/data/torch_campaign_expected.json
(scripts/torch_expected_campaign.py: the JAX package's align_from_pcm on
the CPU); they are not recomputed here. The port rebuilds each input from
the same seeds with its own generator (bench_pair.build_campaign_case)
and first checks that its int16 arrays hash as the fixture's do.

Tolerances, and why:
- nodes: the port's mapping at every JAX fit node within 10 ms (PERF.md
  section 2, the limit every fixture comparison of the port uses);
- similarity within 0.5 points, median slope within 1e-4 (the same
  limits);
- the streamed matcher's LIS chain (integer frame pairs) bit-equal, and
  the retry decision, the returned path (hash and length) and the printed
  progress lines equal: the host tail is the same code on the same LIS
  chain, so equal chains give bit-equal paths on the same host.
"""
import contextlib
import hashlib
import io
import json
import os

import numpy as np
import pytest
import torch

from describealign_tpu_torch.alignment import api as tapi
from describealign_tpu_torch.bench_pair import (CAMPAIGN_CASES,
                                                build_campaign_case)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_campaign_expected.json")
TOL_S = 0.010


def _sha16(x, dtype):
    return hashlib.sha256(np.ascontiguousarray(x, dtype).tobytes()
                          ).hexdigest()[:16]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this file: the tier-1 run puts six workers on
    the machine's cores, where each worker's full thread pool
    oversubscribes them (this file took ~10 min of one worker there with
    the default pool; ~1 min alone with one thread). The results are the
    same at any thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def expected():
    with open(FIXTURE) as f:
        return json.load(f)["cases"]


def test_fixture_holds_every_case(expected):
    assert tuple(expected) == CAMPAIGN_CASES


def test_music_bed_bit_equal_to_jax():
    """The port's copy of music_bed draws what the JAX package's does."""
    from describealign_tpu.utils import synthmedia as jsm
    from describealign_tpu_torch.utils import synthmedia as tsm
    for seed, kw in ((577, {}), (1417, {"amp": 5000.0}),
                     (9, {"motif_seconds": 1.5})):
        want = jsm.music_bed(3.0, seed=seed, **kw)
        got = tsm.music_bed(3.0, seed=seed, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CAMPAIGN_CASES)
def test_campaign_case_matches_jax(name, expected, monkeypatch):
    want = expected[name]
    video, audio = build_campaign_case(name)
    assert video.dtype == audio.dtype == np.int16
    assert (video.shape[1], audio.shape[1]) == (want["video_samples"],
                                                want["audio_samples"])
    assert _sha16(video, np.int16) == want["video_sha256_16"]
    assert _sha16(audio, np.int16) == want["audio_sha256_16"]

    # the streamed matcher's LIS chain, as align_from_pcm computes it
    chains = []
    streamed_lis = tapi._streamed_lis

    def recorded(*args, **kwargs):
        out = streamed_lis(*args, **kwargs)
        chains.append(np.stack([np.asarray(out[0]),
                                np.asarray(out[1])]).astype(np.int64))
        return out
    monkeypatch.setattr(tapi, "_streamed_lis", recorded)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        x, y, sim, path, slope, _ = tapi.align_from_pcm(video, audio,
                                                        device="cpu")
    printed = out.getvalue()
    jx = np.asarray(want["audio_times_s"])
    jy = np.asarray(want["video_times_s"])
    node_err = np.abs(np.interp(jx, x, y) - jy).max()
    assert node_err <= TOL_S, (name, node_err)
    assert abs(sim - want["similarity_percent"]) <= 0.5, (sim, want)
    assert abs(slope - want["median_slope"]) <= 1e-4, (slope, want)
    assert ("rechecking alignment" in printed) == want["retry"]
    chain = chains[0]
    assert chain.shape[1] == want["lis_rows"]
    assert _sha16(chain, np.int64) == want["lis_sha256_16"]
    assert len(path) == want["path_rows"]
    assert _sha16(path, np.float64) == want["path_sha256_16"]
    assert printed == want["printed"]
