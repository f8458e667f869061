"""The seeded generator at a cut size: the layout as the configuration
states it, the truth segments where the content really is, and the same
inputs from the same seed only."""
import numpy as np
import pytest

from conftest import TINY_FILM, TINY_PLAIN, TINY_RATE
from harness import gen

PCM_CFG = {"level": "pcm", "sample_rate": 44100, "content_amp": 6000.0,
           "narration_amp": 5000.0}
FILM_CFG = {"level": "features", "fps": 210, "streams": 5}
SEED = 2 ** 31 + 977


def test_derive_keeps_seeds_and_tags_apart():
    seen = {gen.derive(s, r, j) for s in (11, 12, 2 ** 40 + 11)
            for r in range(3) for j in range(3)}
    assert len(seen) == 27
    assert all(0 <= x < 2 ** 63 for x in seen)


def test_pcm_pair_layout_and_truth():
    p = gen.pcm_pair(PCM_CFG, TINY_PLAIN, SEED, 2.0, "cpu")
    sr = 44100
    assert p.video.dtype == np.int16 and p.video.shape == (1, 60 * sr)
    lead = p.segments[0][0]
    assert abs(lead - 8.0) <= 2.0
    assert p.audio.shape[1] == round(lead * sr) + 60 * sr + 3 * sr
    # every content segment of the description is the video's content,
    # sample for sample, where the truth says
    for a0, a1, v0, v1 in p.segments:
        i, j, n = round(a0 * sr), round(v0 * sr), round((v1 - v0) * sr)
        assert np.array_equal(p.audio[0, i:i + n], p.video[0, j:j + n])
        assert a1 - a0 == pytest.approx(v1 - v0)
    # speech-like statistics: about the configured level, never silent
    x = p.video[0].astype(np.float64)
    assert 4000 < x.std() < 8000
    env = np.abs(x).reshape(-1, 4410).mean(axis=1)
    assert env.min() > 0.05 * env.mean()


def test_resampled_pair_is_slower_by_its_ratio():
    p = gen.pcm_pair(PCM_CFG, TINY_RATE, SEED, 0.0, "cpu")
    (a0, a1, v0, v1), = p.segments
    assert (a1 - a0) / (v1 - v0) == pytest.approx(1.03, abs=1e-6)
    assert a0 == pytest.approx(5.0)


def test_film_pair_copies_whole_frames():
    p = gen.feature_pair(FILM_CFG, TINY_FILM, SEED, 2.0, "cpu")
    assert len(p.video) == len(p.audio) == 5
    assert p.video[0].dtype == np.float32 and len(p.video[0]) == 12600
    assert 3.0 < float(p.video[2].mean()) < 5.0
    for a0, a1, v0, v1 in p.segments:
        i, j, n = round(a0 * 210), round(v0 * 210), round((v1 - v0) * 210)
        for s in range(5):
            assert np.array_equal(p.audio[s][i:i + n], p.video[s][j:j + n])


def test_same_seed_same_inputs_other_seed_other():
    traffic = {"mode": "batch", "layout_set": "b", "rotate": 2,
               "lead_jitter_s": 2.0}
    cfg = dict(PCM_CFG, layouts={"b": [TINY_PLAIN, TINY_RATE]})
    a = gen.make_requests(cfg, traffic, SEED, "cpu")
    b = gen.make_requests(cfg, traffic, SEED, "cpu")
    c = gen.make_requests(cfg, traffic, SEED + 1, "cpu")
    assert len(a) == 2 and all(len(r) == 2 for r in a)
    for ra, rb, rc in zip(a, b, c):
        for pa, pb, pc in zip(ra, rb, rc):
            assert np.array_equal(pa.audio, pb.audio)
            assert pa.segments == pb.segments
            assert not np.array_equal(pa.video, pc.video)
    # the requests of one run differ from each other, in their maps too
    assert a[0][0].segments != a[1][0].segments
    assert not np.array_equal(a[0][0].video, a[1][0].video)


def test_each_request_of_a_run_holds_inputs_of_its_own():
    traffic = {"mode": "single", "layout_set": "s", "rotate": 2,
               "lead_jitter_s": 2.0, "cut_max_s": 0.5}
    cfg = dict(PCM_CFG, layouts={"s": [TINY_PLAIN]})
    reqs = gen.Requests(cfg, traffic, SEED, "cpu")
    again = gen.Requests(cfg, traffic, SEED, "cpu")
    seen = set()
    for i in range(6):
        (p,), (q,) = reqs.next(), again.next()
        base = reqs.base[i % 2][0]
        assert np.shares_memory(p.audio, base.audio)          # a view
        assert p.segments == q.segments                       # seeded
        key = (p.video.shape[1], p.audio.shape[1])
        assert key not in seen
        seen.add(key)
        kv = base.video.shape[1] - p.video.shape[1]
        ka = base.audio.shape[1] - p.audio.shape[1]
        assert 0 <= kv < 22050 and 0 <= ka < 22050
        # the truth moves with the cuts: still the video's content, sample
        # for sample, where it says
        sr = 44100
        for a0, a1, v0, v1 in p.segments:
            assert v0 >= 0.0
            i0, j0 = round(a0 * sr), round(v0 * sr)
            n = round((v1 - v0) * sr) - 1
            assert np.array_equal(p.audio[0, i0:i0 + n], p.video[0, j0:j0 + n])


def test_cuts_keep_the_shape_buckets():
    """The cuts and the lead-in's jitter never move a pair of the real
    configurations across a shape bucket of the program, so every request
    runs the shapes the warm-up ran."""
    import json
    import os
    from conftest import ROOT
    from describealign_tpu_torch.alignment.api import _bucket_pad
    for name in ("tv_episode_22min", "feature_film_95min"):
        with open(os.path.join(ROOT, "benchmark", "configs",
                               name + ".json")) as f:
            cfg = json.load(f)
        fps = 210
        for layouts in cfg["layouts"].values():
            for lay in layouts:
                if cfg["level"] == "pcm":
                    content = lay["content_s"]
                    total = sum(p[1] if p[0] == "narration" else
                                (p[2] - p[1]) * (p[3][0] / p[3][1]
                                                 if len(p) > 3 else 1.0)
                                for p in lay["pieces"])
                else:
                    content = lay["content_frames"] / fps
                    total = sum(p[1] if p[0] == "narration" else p[2] - p[1]
                                for p in lay["pieces"]) / fps
                buckets = {max(_bucket_pad(int((content - cv) * fps)),
                               _bucket_pad(int((total + j - ca) * fps)))
                           for j in (-2.0, 2.0) for cv in (0.0, 0.5)
                           for ca in (0.0, 0.5)}
                assert len(buckets) == 1, (name, buckets)


def test_a_content_seed_gives_every_seed_the_same_work():
    traffic = {"mode": "single", "layout_set": "s", "rotate": 3,
               "lead_jitter_s": 2.0, "cut_max_s": 0.5, "content_seed": 5}
    cfg = dict(PCM_CFG, layouts={"s": [TINY_PLAIN]})
    a = gen.Requests(cfg, traffic, SEED, "cpu")
    b = gen.Requests(cfg, traffic, SEED + 1, "cpu")
    for pa, pb in zip(a.base, b.base):
        assert np.array_equal(pa[0].audio, pb[0].audio)
    firsts = [[r.next()[0].segments for _ in range(3)] for r in (a, b)]
    assert firsts[0] != firsts[1]
