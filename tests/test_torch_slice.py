"""Port parity end to end: the port's align_from_pcm / align against the JAX
package's on the CPU.

The LIS consumes u8-quantized qualities, so the port's chain equals the
JAX one unless an f32 ulp of difference moves a quality across a grid
boundary in a way that changes the chain; the host tail is the same code
on the same path, so equal chains give bit-equal times. The margin is a
difference of two f32 track scores summed in another order: rtol 1e-5.
Printed progress and WARNING lines must be identical.
"""
import numpy as np
import pytest

from describealign_tpu.alignment import api as japi
from describealign_tpu.alignment import matching as jm
from describealign_tpu.utils.synthmedia import build_pair
from describealign_tpu_torch.alignment import api as tapi
from describealign_tpu_torch.alignment import matching as tm

PAIRS = {
    "canonical45": dict(content_seconds=45.0,
                        narration=((15.0, 3.0), (30.0, 4.0)), seed=7),
    "lead_in": dict(content_seconds=30.0, narration=((12.0, 3.0),),
                    lead_in=6.0, seed=11),
}


def _i16_pair(**kw):
    video, audio, _ = build_pair(**kw)
    return (np.clip(video, -32768, 32767).astype(np.int16),
            np.clip(audio, -32768, 32767).astype(np.int16))


def _assert_same_result(got, want):
    assert len(got) == len(want) == 6
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    assert got[2] == want[2]
    assert got[4] == want[4]
    np.testing.assert_allclose(got[5], want[5], rtol=1e-5)


def _lis_paths(v, a):
    sv, sa = v.shape[1], a.shape[1]
    npad = max(japi._bucket_pad(sv // 210), japi._bucket_pad(sa // 210))
    fv, nv = japi.host_features_padded(v, sv, npad)
    fa, na = japi.host_features_padded(a, sa, npad)
    jy, jx, _ = japi._streamed_lis(fa.astype(np.float16), na,
                                   fv.astype(np.float16), nv)
    ty, tx, _ = tapi._streamed_lis(tapi._upload(fa, 'cpu'), na,
                                   tapi._upload(fv, 'cpu'), nv)
    return (jy, jx), (ty, tx)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_align_from_pcm_parity(name, capsys):
    v, a = _i16_pair(**PAIRS[name])
    (jy, jx), (ty, tx) = _lis_paths(v, a)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tx, jx)
    capsys.readouterr()
    want = japi.align_from_pcm(v, a)
    want_out = capsys.readouterr().out
    got = tapi.align_from_pcm(v, a, device='cpu')
    got_out = capsys.readouterr().out
    _assert_same_result(got, want)
    assert got_out == want_out
    assert "matching audio" in got_out


def test_low_margin_retry_parity(monkeypatch, capsys):
    """tests/test_confidence.py's 40-s pair with the confidence floor
    placed (in both packages) so the 5-stream coarse retry runs; both must
    take the same branch and ship the same result."""
    v, a = _i16_pair(content_seconds=40.0, narration=((8.0, 3.0),),
                     lead_in=2.0, seed=78)
    sv, sa = v.shape[1], a.shape[1]
    npad = max(tapi._bucket_pad(sv // 210), tapi._bucket_pad(sa // 210))
    fv, nv = tapi.host_features_padded(v, sv, npad)
    fa, na = tapi.host_features_padded(a, sa, npad)
    m3 = float(tm.match_coarse(tapi._upload(fa, 'cpu'), na,
                               tapi._upload(fv, 'cpu'), nv)[7])
    m5n = (float(tm.match_coarse(tapi._upload(fa, 'cpu'), na,
                                 tapi._upload(fv, 'cpu'), nv, nf=5)[7])
           * tm.COARSE_STREAMS / tm.COARSE_RETRY_STREAMS)
    if m5n > m3 + 0.01:      # acceptance branch
        floor = m3 + (min(m5n, 2.0 * m3) - m3) / 2
    else:                    # rejection branch
        floor = max(m3, m5n) * 1.5
    monkeypatch.setattr(jm, 'COARSE_MARGIN_FLOOR', floor)
    monkeypatch.setattr(tm, 'COARSE_MARGIN_FLOOR', floor)
    capsys.readouterr()
    want = japi.align_from_pcm(v, a)
    japi.warn_low_confidence(want[5])
    want_out = capsys.readouterr().out
    got = tapi.align_from_pcm(v, a, device='cpu')
    tapi.warn_low_confidence(got[5])
    got_out = capsys.readouterr().out
    assert "rechecking alignment" in got_out
    _assert_same_result(got, want)
    assert got_out == want_out


def test_align_features_parity(capsys):
    """The feature-list entry align(): same 5-tuple and printed lines."""
    v, a = _i16_pair(**PAIRS["canonical45"])
    fv, nv = japi.host_features_padded(v)
    fa, na = japi.host_features_padded(a)
    vf = [fv[j, :nv] for j in range(5)]
    af = [fa[j, :na] for j in range(5)]
    capsys.readouterr()
    want = japi.align(vf, af, vf[0], af[0])
    want_out = capsys.readouterr().out
    got = tapi.align(vf, af, vf[0], af[0], device='cpu')
    got_out = capsys.readouterr().out
    assert len(got) == len(want) == 5
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    assert got[2] == want[2] and got[4] == want[4]
    assert got_out == want_out


def test_cpu_path_and_stage_timings():
    """On CPU tensors the fine wrapper takes the plain version and never
    counts a kernel launch; a timings dict receives every stage."""
    from describealign_tpu_torch.ops import fine_kernel
    before = fine_kernel.fine_match.launches
    v, a = _i16_pair(content_seconds=14.0, narration=(), lead_in=2.0,
                     seed=3)
    timings = {}
    out = tapi.align_from_pcm(v, a, device='cpu', timings=timings)
    assert abs(float(out[0][0] - out[1][0]) - 2.0) < 0.05
    assert fine_kernel.fine_match.launches == before
    assert set(timings) == {'features', 'coarse_map', 'coarse_dp', 'fine',
                            'lis_tail'}
    assert all(t >= 0 for t in timings.values())


@pytest.mark.parametrize("backend", ["native", "highs"])
def test_fit_backend_parity(backend):
    """The re-homed L1 fit (and the continuity errors its jump costs use)
    is the JAX package's code: equal nodes give bit-equal fits."""
    from describealign_tpu.alignment import fit as jfit
    from describealign_tpu_torch.alignment import fit as tfit
    rng = np.random.default_rng(9)
    x = np.cumsum(rng.uniform(20.0, 80.0, 300))
    y = (x - 1000.0 + np.where(x > x[150], -600.0, 0.0)
         + rng.normal(0.0, 0.5, 300))
    want = jfit.solve_l1_fit(x, y, backend=backend)
    got = tfit.solve_l1_fit(x, y, backend=backend)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_retry_kernel_error_propagates(monkeypatch, capsys):
    """A fine-kernel failure inside the 5-stream retry is raised, not
    hidden behind the original low-confidence result."""
    from describealign_tpu_torch.ops import fine_kernel
    real = fine_kernel.fine_match
    calls = []

    def failing(*args):
        calls.append(1)
        if len(calls) > tm.N_TRACKS:      # the first pass is one chunk
            raise RuntimeError("fine_match: forced launch failure")
        return real(*args)
    monkeypatch.setattr(fine_kernel, 'fine_match', failing)
    monkeypatch.setattr(tm, 'COARSE_MARGIN_FLOOR', 1e9)
    v, a = _i16_pair(content_seconds=14.0, narration=(), lead_in=2.0,
                     seed=3)
    capsys.readouterr()
    with pytest.raises(RuntimeError, match="forced launch failure"):
        tapi.align_from_pcm(v, a, device='cpu')
    assert "rechecking alignment" in capsys.readouterr().out
    assert len(calls) == tm.N_TRACKS + 1


def test_bench_pair_is_bench_py_pair(monkeypatch, tmp_path):
    """The port's bench pair asks its copy of the generator for bench.py's
    pair (same arguments) and returns it as int16, cached when asked; the
    copy generates the JAX package's pairs bit for bit."""
    import bench
    from describealign_tpu.utils import synthmedia
    from describealign_tpu_torch.bench_pair import build_scale_pair
    from describealign_tpu_torch.utils import synthmedia as port_synthmedia
    seen = []

    def fake_build_pair(**kw):
        seen.append(kw)
        rng = np.random.default_rng(0)
        return (rng.normal(0, 4e4, (2, 500)), rng.normal(0, 10, (2, 600)),
                None)
    monkeypatch.setattr(synthmedia, 'build_pair', fake_build_pair)
    monkeypatch.setattr(port_synthmedia, 'build_pair', fake_build_pair)
    monkeypatch.setattr(bench, 'BENCH_PAIR_CACHE', str(tmp_path / "b.npz"))
    video, audio, _ = bench.build_scale_pair()
    cache = str(tmp_path / "port" / "pair.npz")
    v, a = build_scale_pair(cache)
    assert len(seen) == 2 and seen[0] == seen[1]
    np.testing.assert_array_equal(
        v, np.clip(video, -32768, 32767).astype(np.int16))
    np.testing.assert_array_equal(
        a, np.clip(audio, -32768, 32767).astype(np.int16))
    v2, a2 = build_scale_pair(cache)
    assert len(seen) == 2 and v2.dtype == np.int16
    np.testing.assert_array_equal(v2, v)
    np.testing.assert_array_equal(a2, a)
    monkeypatch.undo()
    kw = dict(content_seconds=3.0, narration=((1.0, 0.5),), lead_in=0.5,
              seed=9, channels=2)
    want = synthmedia.build_pair(**kw)
    got = port_synthmedia.build_pair(**kw)
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(x, y)
    assert got[2] == want[2]
