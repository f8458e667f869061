"""Port parity: combine() and the CLI, the JAX package's against the port's
on the CPU.

The two packages run on the same WAV pairs (the 40-s pair of
tests/test_pipeline.py) into separate directories. Their alignments are
bit-equal (tests/test_torch_slice.py), and the stretch, mux and report code
is the same code, so the output media must be byte-identical, and the
.txt reports and the printed lines identical once the run directories
are named alike; the reports' `Version:` and `Script Hash:` lines name
each package and are left out. Directories of more than one pair go through
the batch branch (_BatchAligner, align_batch_from_pcm) in both packages: the
same bytes and the same printed lines, and the port's sequential loop
(_use_batch patched off) gives the same bytes as its batch branch.
"""
import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

from describealign_tpu import cli as jcli
from describealign_tpu import pipeline as jpipe
from describealign_tpu.media import ffmpeg as jff
from describealign_tpu.media.decode import write_wav
from describealign_tpu_torch import cli as tcli
from describealign_tpu_torch import pipeline as tpipe
from describealign_tpu_torch.alignment import api as tapi
from describealign_tpu_torch.media import ffmpeg as tff
from tests.synth import build_pair, speech_like

FAKEBIN = os.path.join(os.path.dirname(__file__), "fakebin.py")


@pytest.fixture(scope="module")
def wav_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("media")
    video, audio, _ = build_pair(content_seconds=40.0, narration=(),
                                 lead_in=6.0, seed=3, channels=2)
    video_wav, audio_wav = tmp / "episode_1.wav", tmp / "described_1.wav"
    write_wav(video_wav, video)
    write_wav(audio_wav, audio)
    return str(video_wav), str(audio_wav)


def _run(fn, capsys, *args, **kwargs):
    """stdout of fn(*args, **kwargs)."""
    capsys.readouterr()
    fn(*args, **kwargs)
    return capsys.readouterr().out


def _dirs(root):
    return str(root / "out"), str(root / "plots")


def _same_text(got, want, got_root, want_root):
    """Equal once both run directories read <run> and the Version /
    Script Hash / Processing-files lines (one per package) are left out."""
    def norm(text, root):
        text = text.replace(str(root), "<run>")
        return [ln for ln in text.split("\n")
                if not ln.startswith(("Version:", "Script Hash:",
                                      "Processing files with v"))]
    assert norm(got, got_root) == norm(want, want_root)


def _read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


def _assert_same_run(got_root, want_root, stem, out_name):
    for root in (got_root, want_root):
        assert os.path.exists(root / "plots" / f"{stem}.png")
    assert (_read(got_root / "out" / out_name, "rb")
            == _read(want_root / "out" / out_name, "rb"))
    _same_text(_read(got_root / "plots" / f"{stem}.txt"),
               _read(want_root / "plots" / f"{stem}.txt"),
               got_root, want_root)


def _on_cpu(monkeypatch):
    """The port's combine() with device='cpu', as the CLI reaches it."""
    real = tpipe.combine
    monkeypatch.setattr(tpipe, "combine",
                        lambda *a, **k: real(*a, device="cpu", **k))


@pytest.fixture(scope="module")
def jax_stretch(wav_pair, tmp_path_factory):
    """The JAX CLI in stretch mode on the pair: (root, printed)."""
    root = tmp_path_factory.mktemp("jax_stretch")
    out, plots = _dirs(root)
    import io
    from contextlib import redirect_stdout
    with redirect_stdout(io.StringIO()) as buf:
        jcli.command_line_interface(list(wav_pair) + [
            "--stretch_audio", "--yes", "--output_dir", out,
            "--alignment_dir", plots])
    return root, buf.getvalue()


def test_combine_stretch_matches_jax(wav_pair, jax_stretch, tmp_path,
                                     capsys):
    want_root, want_printed = jax_stretch
    out, plots = _dirs(tmp_path)
    printed = _run(tpipe.combine, capsys, [wav_pair[0]], [wav_pair[1]],
                   stretch_audio=True, yes=True, output_dir=out,
                   alignment_dir=plots, device="cpu")
    _assert_same_run(tmp_path, want_root, "episode_1", "ad_episode_1.wav")
    _same_text(printed, want_printed, tmp_path, want_root)
    assert "  computing video features... \r" in printed


def test_cli_wav_pair_matches_jax_cli(wav_pair, jax_stretch, tmp_path,
                                      capsys, monkeypatch):
    want_root, want_printed = jax_stretch
    _on_cpu(monkeypatch)
    out, plots = _dirs(tmp_path)
    printed = _run(tcli.command_line_interface, capsys, list(wav_pair) + [
        "--stretch_audio", "--yes", "--output_dir", out, "--alignment_dir",
        plots])
    _assert_same_run(tmp_path, want_root, "episode_1", "ad_episode_1.wav")
    _same_text(printed, want_printed, tmp_path, want_root)


def test_combine_no_pitch_correction_matches_jax(wav_pair, tmp_path,
                                                 capsys):
    runs = {}
    for name, combine, kw in (("jax", jpipe.combine, {}),
                              ("port", tpipe.combine, {"device": "cpu"})):
        out, plots = _dirs(tmp_path / name)
        runs[name] = _run(combine, capsys, [wav_pair[0]], [wav_pair[1]],
                          stretch_audio=True, yes=True,
                          no_pitch_correction=True, output_dir=out,
                          alignment_dir=plots, **kw)
    _assert_same_run(tmp_path / "port", tmp_path / "jax", "episode_1",
                     "ad_episode_1.wav")
    _same_text(runs["port"], runs["jax"], tmp_path / "port",
               tmp_path / "jax")


def test_combine_resume_skips_existing(wav_pair, tmp_path, capsys):
    printed = {}
    for name, combine, kw in (("jax", jpipe.combine, {}),
                              ("port", tpipe.combine, {"device": "cpu"})):
        out, plots = _dirs(tmp_path / name)
        os.makedirs(out)
        with open(os.path.join(out, "ad_episode_1.wav"), "wb") as f:
            f.write(b"\0" * 200000)        # > 1e5 bytes: treated as done
        printed[name] = _run(combine, capsys, [wav_pair[0]], [wav_pair[1]],
                             stretch_audio=True, yes=True, output_dir=out,
                             alignment_dir=plots, **kw)
        assert os.path.getsize(os.path.join(out, "ad_episode_1.wav")) \
            == 200000
    assert "output file already exists, skipping..." in printed["port"]
    _same_text(printed["port"], printed["jax"], tmp_path / "port",
               tmp_path / "jax")


def test_alignment_cache_reused(wav_pair, tmp_path, monkeypatch):
    plots = str(tmp_path / "plots")
    tpipe.combine([wav_pair[0]], [wav_pair[1]], stretch_audio=True, yes=True,
                  output_dir=str(tmp_path / "o1"), alignment_dir=plots,
                  device="cpu")

    def boom(*a, **k):
        raise AssertionError("align_from_pcm must not run on a cache hit")

    monkeypatch.setattr(tapi, "align_from_pcm", boom)
    tpipe.combine([wav_pair[0]], [wav_pair[1]], stretch_audio=True, yes=True,
                  output_dir=str(tmp_path / "o2"), alignment_dir=plots,
                  device="cpu")
    assert (_read(tmp_path / "o1" / "ad_episode_1.wav", "rb")
            == _read(tmp_path / "o2" / "ad_episode_1.wav", "rb"))


def _write_directory(root, seeds):
    vids, auds = root / "vids", root / "auds"
    vids.mkdir()
    auds.mkdir()
    for idx, seed in enumerate(seeds, 1):
        video, audio, _ = build_pair(content_seconds=40.0, narration=(),
                                     lead_in=6.0, seed=seed, channels=2)
        write_wav(vids / f"show_ep{idx}.wav", video)
        write_wav(auds / f"show_ep{idx}_described.wav", audio)
    return str(vids), str(auds)


def test_directory_two_pairs_matches_jax_batched(tmp_path, monkeypatch):
    vids, auds = _write_directory(tmp_path, (3, 11))
    import describealign_tpu.alignment.api as japi
    calls = {"batch": 0, "port_batch": 0, "single": 0}
    real_batch = japi.align_batch_from_pcm
    real_port_batch = tapi.align_batch_from_pcm
    real_single = tapi.align_from_pcm

    def count_batch(*a, **k):
        calls["batch"] += 1
        return real_batch(*a, **k)

    def count_port_batch(pairs, *a, **k):
        calls["port_batch"] += len(pairs)
        return real_port_batch(pairs, *a, **k)

    def count_single(*a, **k):
        calls["single"] += 1
        return real_single(*a, **k)

    monkeypatch.setattr(japi, "align_batch_from_pcm", count_batch)
    monkeypatch.setattr(tapi, "align_batch_from_pcm", count_port_batch)
    monkeypatch.setattr(tapi, "align_from_pcm", count_single)
    monkeypatch.delenv("DESCRIBEALIGN_BATCH", raising=False)
    for name, combine, kw in (("jax", jpipe.combine, {}),
                              ("port", tpipe.combine, {"device": "cpu"})):
        out, plots = _dirs(tmp_path / name)
        combine(vids, auds, stretch_audio=True, yes=True,
                output_dir=out, alignment_dir=plots, **kw)
    assert calls == {"batch": 1, "port_batch": 2, "single": 0}
    for idx in (1, 2):
        _assert_same_run(tmp_path / "port", tmp_path / "jax",
                         f"show_ep{idx}", f"ad_show_ep{idx}.wav")


@pytest.fixture(scope="module")
def three_pair_runs(tmp_path_factory):
    """A 3-pair directory through both packages' batch branches:
    (vids, auds, {name: (root, printed)})."""
    import io
    from contextlib import redirect_stdout
    root = tmp_path_factory.mktemp("batch3")
    vids, auds = _write_directory(root, (3, 11, 23))
    runs = {}
    for name, combine, kw in (("jax", jpipe.combine, {}),
                              ("port", tpipe.combine, {"device": "cpu"})):
        out, plots = _dirs(root / name)
        with redirect_stdout(io.StringIO()) as buf:
            combine(vids, auds, stretch_audio=True, yes=True,
                    output_dir=out, alignment_dir=plots, **kw)
        runs[name] = (root / name, buf.getvalue())
    return vids, auds, runs


def test_directory_batch_matches_jax_batched(three_pair_runs):
    """WAVs, reports and printed lines of the port's batch branch against
    the JAX package's batched run, line for line."""
    _, _, runs = three_pair_runs
    (port, printed), (jax_root, jax_printed) = runs["port"], runs["jax"]
    for idx in (1, 2, 3):
        _assert_same_run(port, jax_root, f"show_ep{idx}",
                         f"ad_show_ep{idx}.wav")
    _same_text(printed, jax_printed, port, jax_root)
    # the batch tail is quiet: per pair only the consumer loop's lines
    assert printed.count("  reading video file...\r") == 3
    assert "matching audio" not in printed
    assert "refining match" not in printed


def test_directory_batch_matches_sequential_loop(three_pair_runs, tmp_path,
                                                 monkeypatch):
    vids, auds, runs = three_pair_runs
    calls = {"batch": 0, "single": 0}
    real_single = tapi.align_from_pcm

    def count_single(*a, **k):
        calls["single"] += 1
        return real_single(*a, **k)

    def count_batch(*a, **k):
        calls["batch"] += 1
        raise AssertionError("the batch path ran with _use_batch off")

    assert [tpipe._use_batch(n) for n in (0, 1, 2, 8)] == [False, False,
                                                           True, True]
    monkeypatch.setattr(tapi, "align_from_pcm", count_single)
    monkeypatch.setattr(tapi, "align_batch_from_pcm", count_batch)
    monkeypatch.setattr(tpipe, "_use_batch", lambda n_work: False)
    out, plots = _dirs(tmp_path)
    tpipe.combine(vids, auds, stretch_audio=True, yes=True, output_dir=out,
                  alignment_dir=plots, device="cpu")
    assert calls == {"batch": 0, "single": 3}
    for idx in (1, 2, 3):
        _assert_same_run(tmp_path, runs["port"][0], f"show_ep{idx}",
                         f"ad_show_ep{idx}.wav")
    assert tpipe.BATCH_GROUP_SIZE == 8


def test_batch_skip_and_cache_interleave(three_pair_runs, tmp_path,
                                         monkeypatch, capsys):
    """Batched directory mode keeps skip/resume and cached-alignment
    semantics for interleaved pairs (tests/test_pipeline.py:265-310)."""
    vids, auds, runs = three_pair_runs
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    plots = str(tmp_path / "plots")
    with open(out_dir / "ad_show_ep2.wav", "wb") as f:
        f.write(b"\0" * 200000)             # pair 2 is done: resume skip
    seen = {"batch_pairs": 0, "single": 0}
    real_batch = tapi.align_batch_from_pcm
    real_single = tapi.align_from_pcm

    def spy_batch(pairs, *a, **k):
        seen["batch_pairs"] += len(pairs)
        return real_batch(pairs, *a, **k)

    def spy_single(*a, **k):
        seen["single"] += 1
        return real_single(*a, **k)

    monkeypatch.setattr(tapi, "align_batch_from_pcm", spy_batch)
    monkeypatch.setattr(tapi, "align_from_pcm", spy_single)
    printed = _run(tpipe.combine, capsys, vids, auds, stretch_audio=True,
                   yes=True, output_dir=str(out_dir), alignment_dir=plots,
                   device="cpu")
    assert "output file already exists, skipping..." in printed
    assert os.path.getsize(out_dir / "ad_show_ep2.wav") == 200000
    assert seen == {"batch_pairs": 2, "single": 0}
    for idx in (1, 3):
        assert (_read(out_dir / f"ad_show_ep{idx}.wav", "rb")
                == _read(runs["port"][0] / "out" / f"ad_show_ep{idx}.wav",
                         "rb"))
    # a second run into a fresh output directory: pairs 1 and 3 hit the
    # alignment cache, pair 2 aligns for the first time; one work pair
    # stays on the sequential loop
    tpipe.combine(vids, auds, stretch_audio=True, yes=True,
                  output_dir=str(tmp_path / "out2"), alignment_dir=plots,
                  device="cpu")
    assert seen == {"batch_pairs": 2, "single": 1}
    for idx in (1, 2, 3):
        assert (_read(tmp_path / "out2" / f"ad_show_ep{idx}.wav", "rb")
                == _read(runs["port"][0] / "out" / f"ad_show_ep{idx}.wav",
                         "rb"))


def test_batch_worker_error_surfaces_in_combine(three_pair_runs, tmp_path,
                                                monkeypatch):
    """An error on the batch aligner's worker thread is raised by
    combine() on the calling thread, before any output is written."""
    vids, auds, _ = three_pair_runs

    def failing(*a, **k):
        raise RuntimeError("align_batch_from_pcm: forced failure")

    monkeypatch.setattr(tapi, "align_batch_from_pcm", failing)
    out, plots = _dirs(tmp_path)
    with pytest.raises(RuntimeError, match="forced failure"):
        tpipe.combine(vids, auds, stretch_audio=True, yes=True,
                      output_dir=out, alignment_dir=plots, device="cpu")
    assert os.listdir(out) == []


@pytest.fixture()
def fake_ffmpeg(tmp_path, monkeypatch):
    """tests/fakebin.py as the ffmpeg and ffprobe of both packages."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for tool in ("ffmpeg", "ffprobe"):
        shim = bindir / tool
        shim.write_text(f"#!/bin/sh\nexec '{sys.executable}' '{FAKEBIN}' "
                        f"{tool} \"$@\"\n")
        shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("DESCRIBEALIGN_FFMPEG", str(bindir / "ffmpeg"))
    monkeypatch.setenv("DESCRIBEALIGN_FFPROBE", str(bindir / "ffprobe"))
    jff._reset_discovery_cache()
    tff._reset_discovery_cache()
    yield
    jff._reset_discovery_cache()
    tff._reset_discovery_cache()


def test_default_mode_matches_jax(fake_ffmpeg, tmp_path, capsys):
    """Default (setts) mode: the executed ffmpeg argv and the output are
    the JAX run's (tests/test_default_mode_e2e.py's pair: a 6 s intro, so
    the video is cut at a keyframe)."""
    content = speech_like(40.0, seed=9)
    intro = speech_like(6.0, seed=1009, amp=5000.0)
    video_file = tmp_path / "episode_1.mp4"      # WAV payload
    audio_file = tmp_path / "described_1.wav"
    write_wav(video_file, np.concatenate([intro, content])[None, :])
    write_wav(audio_file, content[None, :])
    printed = {}
    for name, combine, kw in (("jax", jpipe.combine, {}),
                              ("port", tpipe.combine, {"device": "cpu"})):
        out, plots = _dirs(tmp_path / name)
        printed[name] = _run(combine, capsys, [str(video_file)],
                             [str(audio_file)], yes=True, output_dir=out,
                             alignment_dir=plots, **kw)
    port, jax_root = tmp_path / "port", tmp_path / "jax"
    args = [json.loads(_read(root / "out" / "ad_episode_1.mp4.ffargs.json")
                       .replace(str(root), "<run>"))
            for root in (port, jax_root)]
    assert args[0] == args[1]
    assert any(a.startswith("setts=pts='TS+(0") for a in args[0])
    _assert_same_run(port, jax_root, "episode_1", "ad_episode_1.mp4")
    _same_text(printed["port"], printed["jax"], port, jax_root)


def test_stretch_required_for_audio_pairs(wav_pair, fake_ffmpeg, tmp_path):
    errors = []
    for name, combine, kw in (("jax", jpipe.combine, {}),
                              ("port", tpipe.combine, {"device": "cpu"})):
        out, plots = _dirs(tmp_path / name)
        with pytest.raises(RuntimeError) as exc:
            combine([wav_pair[0]], [wav_pair[1]], yes=True, output_dir=out,
                    alignment_dir=plots, **kw)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert "--stretch_audio is required" in errors[1]


def test_cli_version(capsys):
    out = _run(tcli.command_line_interface, capsys, ["--version"])
    assert "version: 0.1.0" in out
    assert "content hash:" in out
    assert os.path.join("describealign_tpu_torch") in out.split("path: ")[1]


def test_cli_usage_without_arguments(capsys):
    """Without wxPython the GUI cannot start: the JAX CLI's message for a
    missing GUI, then the usage line."""
    out = _run(tcli.command_line_interface, capsys, [])
    assert out == ("Can't launch GUI and arguments missing.\n"
                   "GUI dependencies missing.\n"
                   "usage: describealign-tpu-torch video_file.mp4 "
                   "audio_file.mp3\n")


def test_cli_fit_backend_highs(wav_pair, tmp_path, monkeypatch):
    """--fit_backend reaches the fit for the run and no further."""
    from describealign_tpu_torch.alignment import fit as tfit
    _on_cpu(monkeypatch)
    seen = []
    real = tfit.solve_l1_fit

    def spy(x, y, backend='highs', device='cuda'):
        seen.append(backend)
        return real(x, y, backend=backend, device=device)

    monkeypatch.setattr(tfit, "solve_l1_fit", spy)
    tcli.command_line_interface(list(wav_pair) + [
        "--stretch_audio", "--yes", "--fit_backend", "highs",
        "--output_dir", str(tmp_path / "o"), "--alignment_dir",
        str(tmp_path / "p")])
    assert seen and set(seen) == {"highs"}
    assert tapi.DEFAULT_FIT_BACKEND == "native"
    assert os.path.exists(tmp_path / "p" / "episode_1.txt")


def test_cli_fit_backend_device_names_the_roadmap(wav_pair, tmp_path,
                                                  monkeypatch, capsys):
    """--fit_backend device is accepted (it exited naming ROADMAP A13
    before the device fit was ported): the fit runs the ADMM on the
    matcher's device, here the CPU's plain version, and converges."""
    from describealign_tpu_torch.alignment import fit as tfit
    _on_cpu(monkeypatch)
    seen = []
    real = tfit.solve_l1_fit

    def spy(x, y, backend='highs', device='cuda'):
        seen.append((backend, str(device)))
        return real(x, y, backend=backend, device=device)

    monkeypatch.setattr(tfit, "solve_l1_fit", spy)
    tcli.command_line_interface(list(wav_pair) + [
        "--stretch_audio", "--yes", "--fit_backend", "device",
        "--output_dir", str(tmp_path / "o"), "--alignment_dir",
        str(tmp_path / "p")])
    assert seen and set(seen) == {("device", "cpu")}
    assert "WARNING: device fit" not in capsys.readouterr().out
    assert tapi.DEFAULT_FIT_BACKEND == "native"
    assert os.path.exists(tmp_path / "p" / "episode_1.txt")


def test_cli_warmup_builds_or_names_nvcc(capsys):
    """--warmup builds the CUDA kernel and the host library; where nvcc is
    missing (here) the build raises naming it."""
    import shutil
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present: the warm-up would build the kernel")
    with pytest.raises(RuntimeError, match="nvcc"):
        tcli.command_line_interface(["--warmup", "1"])


def test_cli_without_cuda_fails_naming_cuda(wav_pair, tmp_path, monkeypatch):
    """Unwrapped, the CLI runs on the card: without CUDA it raises before
    any alignment and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the CLI would run on the card")

    def boom(*a, **k):
        raise AssertionError("the CLI ran the matcher without CUDA")

    monkeypatch.setattr(tapi, "align_from_pcm", boom)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.command_line_interface(list(wav_pair) + [
            "--stretch_audio", "--yes", "--output_dir", str(tmp_path / "o"),
            "--alignment_dir", str(tmp_path / "p")])
    assert not os.path.exists(tmp_path / "o")
