"""Port parity: the port's own host C++ library against the JAX package's.

The port builds csrc/dp.cpp + csrc/features.cpp (copies of the JAX
package's native sources) into build/describealign_tpu_torch/ with its own
loader. On one synthetic pair the two libraries give bit-equal host
features and the same streaming LIS chain.
"""
import os

import numpy as np
import pytest
import torch

from describealign_tpu.alignment import api as japi
from describealign_tpu.alignment.native import native_lib as jax_native_lib
from describealign_tpu.ops.host_features import \
    extract_features_host as jax_extract
from describealign_tpu_torch.alignment import api as tapi
from describealign_tpu_torch.alignment import matching as tm
from describealign_tpu_torch.alignment.native import native_lib
from describealign_tpu_torch.ops import _build
from describealign_tpu_torch.ops.host_features import extract_features_host
from describealign_tpu_torch.utils.synthmedia import build_pair


@pytest.fixture(scope='module')
def pair():
    video, audio, _ = build_pair(content_seconds=20.0,
                                 narration=((8.0, 2.0),), lead_in=1.5,
                                 seed=5, channels=2)
    return (np.clip(video, -32768, 32767).astype(np.int16),
            np.clip(audio, -32768, 32767).astype(np.int16))


def test_port_library_is_its_own(pair):
    path = native_lib()._name
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path) == 'libdadp.so'
    assert path != jax_native_lib()._name


@pytest.mark.parametrize('which', ['video', 'audio'])
def test_host_features_bit_equal(pair, which):
    pcm = pair[0] if which == 'video' else pair[1]
    true_samples = pcm.shape[1] - 1234          # a ragged true length
    got = extract_features_host(pcm, true_samples)
    want = jax_extract(pcm, true_samples)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    # the in-place form writes the same rows
    out = np.zeros((5, true_samples // 210 + 10), np.float32)
    rows = extract_features_host(pcm, true_samples, out=out)
    assert rows[0].base is out
    for g, w in zip(rows, want):
        np.testing.assert_array_equal(g, w)


def test_streaming_lis_equal(pair):
    """The port's matcher output, fed to both libraries' streaming LIS,
    gives the same (video, audio) chain."""
    v, a = pair
    npad = max(tapi._bucket_pad(v.shape[1] // 210),
               tapi._bucket_pad(a.shape[1] // 210))
    fv, nv = tapi.host_features_padded(v, v.shape[1], npad)
    fa, na = tapi.host_features_padded(a, a.shape[1], npad)
    chunks, starts, _, _ = tm.match_stream(
        tapi._upload(fa, torch.device('cpu')), na,
        tapi._upload(fv, torch.device('cpu')), nv)
    packed = [c.numpy() for c in chunks]
    starts = starts.numpy()
    y_t, x_t = tapi._consume_stream(iter(packed), starts)
    y_j, x_j = japi._consume_stream(iter(packed), starts)
    assert len(x_t) > 1000
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(x_t, x_j)


def test_failed_build_raises_with_compiler_stderr(tmp_path, monkeypatch):
    """No silent fallback: a source g++ rejects raises with its stderr."""
    (tmp_path / 'broken.cpp').write_text('extern "C" int f( {\n')
    monkeypatch.setattr(_build, 'CSRC', str(tmp_path))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match=r'g\+\+ failed for broken') as e:
        _build.build_host_library('broken', ['broken.cpp'])
    assert 'broken.cpp' in str(e.value)
    assert not (tmp_path / 'build' / 'libbroken.so').exists()
