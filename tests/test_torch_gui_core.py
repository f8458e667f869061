"""Headless tests for the port's GUI logic layer (no wx required): the
cases of tests/test_gui_core.py against describealign_tpu_torch.gui.core,
then the port's own: the worker's output against combine() called
directly, the spawned worker, and the config path kept apart from the JAX
package's."""
import multiprocessing
import os

import pytest

from describealign_tpu_torch.gui import core


# --- transcript / progress-line state machine --------------------------------

def test_plain_lines_append():
    m = core.TranscriptModel()
    ops = m.feed("hello\n") + m.feed("world\n")
    assert [o.kind for o in ops] == ["append", "append"]
    assert m.text() == "hello\nworld"


def test_print_style_split_chunks_merge():
    # print("abc") arrives as two writes: "abc" then "\n"
    m = core.TranscriptModel()
    m.feed("abc")
    m.feed("\n")
    m.feed("def")
    m.feed("\n")
    assert m.text() == "abc\ndef"


def test_carriage_return_overwrites_last_line():
    m = core.TranscriptModel()
    m.feed("  matching audio...  \r")
    ops = m.feed("  refining match: pass 1 of 2...\r")
    assert ops[0].kind == "replace_last"
    ops = m.feed("done\n")
    assert ops[0].kind == "replace_last"
    assert m.text() == "done"


def test_blank_lines_preserved():
    m = core.TranscriptModel()
    m.feed("a\n")
    m.feed("\n")
    m.feed("b\n")
    assert m.text() == "a\n\nb"


def test_severity_classification():
    assert core.classify_line("  WARNING: similarity 12%") == "warning"
    assert core.classify_line("  ERROR: processing failed") == "error"
    assert core.classify_line("WARNING: not indented") is None
    assert core.classify_line("reading media files...") is None
    m = core.TranscriptModel()
    ops = m.feed("  WARNING: check inputs\n")
    assert ops[0].tag == "warning"


def test_partial_line_grows_in_place():
    m = core.TranscriptModel()
    m.feed("loading ")
    ops = m.feed("done")
    assert ops[0].kind == "replace_last"
    assert m.text() == "loading done"


# --- queue writer / child process --------------------------------------------

def test_queue_writer_forwards_chunks():
    import queue
    q = queue.Queue()
    w = core.QueueWriter(q)
    print("hello", file=w)
    w.write("")  # empty writes are dropped
    got = []
    while not q.empty():
        got.append(q.get())
    assert "".join(got) == "hello\n"


def test_run_combine_to_queue_reports_errors():
    import queue
    q = queue.Queue()
    settings = dict(stretch_audio=False, prepend="ad_",
                    no_pitch_correction=False, output_dir="/nonexistent",
                    alignment_dir="/nonexistent")
    # empty inputs make combine raise quickly; the wrapper must surface it
    core.run_combine_to_queue(q, ["/no/such/file.mp4"], [], settings)
    out = []
    while not q.empty():
        out.append(q.get())
    text = "".join(out)
    assert "  ERROR: processing failed" in text
    assert "Traceback" in text


# --- settings model -----------------------------------------------------------

def test_settings_model_round_trip(tmp_path):
    path = tmp_path / "config.ini"
    m = core.SettingsModel(path)
    assert m.values["prepend"] == "ad_"
    assert m.field_enabled("no_pitch_correction") is False  # gated
    m.set("stretch_audio", True)
    assert m.field_enabled("no_pitch_correction") is True
    m.set("prepend", "x_")
    m.save()
    m2 = core.SettingsModel(path)
    assert m2.values["stretch_audio"] is True
    assert m2.values["prepend"] == "x_"
    with pytest.raises(KeyError):
        m.set("bogus", 1)


def test_settings_schema_covers_combine_kwargs():
    keys = {f["key"] for f in core.SETTINGS_FIELDS}
    assert keys == {"stretch_audio", "no_pitch_correction", "prepend",
                    "output_dir", "alignment_dir"}


# --- file list helpers ---------------------------------------------------------

def test_expand_paths_filters_sorts_and_walks_dirs(tmp_path):
    d = tmp_path / "season"
    d.mkdir()
    names = ["ep10.mp4", "ep2.mp4", "ep1.mp4", "notes.txt"]
    for n in names:
        (d / n).write_bytes(b"x")
    loose = tmp_path / "bonus.mkv"
    loose.write_bytes(b"x")
    got = core.expand_paths([str(d), str(loose), str(tmp_path / "no.txt")],
                            {"mp4", "mkv"})
    assert [os.path.basename(p) for p in got] == \
        ["bonus.mkv", "ep1.mp4", "ep2.mp4", "ep10.mp4"]


def test_validate_selection_messages():
    assert core.validate_selection([], []) is not None
    assert core.validate_selection(["v"], []) is not None
    assert core.validate_selection([], ["a"]) is not None
    assert "counts differ" in core.validate_selection(["v1", "v2"], ["a1"])
    assert core.validate_selection(["v"], ["a"]) is None


def test_wildcard_string():
    w = core.wildcard_for({"mp3", "wav"}, "Audio files")
    assert w.startswith("Audio files (*.mp3;*.wav)|*.mp3;*.wav")


# --- the port's worker: combine()'s output, and in a spawned child ---------

def _wav_pair(root):
    """A 14-s stereo WAV pair (2-s lead-in) from the port's build_pair."""
    from describealign_tpu_torch.media.decode import write_wav
    from describealign_tpu_torch.utils.synthmedia import build_pair
    video, audio, _ = build_pair(content_seconds=12.0, narration=(),
                                 lead_in=2.0, seed=5, channels=2)
    video_wav, audio_wav = str(root / "film.wav"), str(root / "desc.wav")
    write_wav(video_wav, video)
    write_wav(audio_wav, audio)
    return video_wav, audio_wav


def _settings(root):
    return dict(stretch_audio=True, prepend="ad_", no_pitch_correction=False,
                output_dir=str(root / "out"),
                alignment_dir=str(root / "plots"))


def _outputs(root):
    """{name: bytes} of the output WAV and the .txt report."""
    return {name: open(path, "rb").read() for name, path in (
        ("wav", root / "out" / "ad_film.wav"),
        ("txt", root / "plots" / "film.txt"))}


def _drain(queue, worker, timeout=240.0):
    """Every chunk the worker puts, until it exits."""
    import queue as queue_mod
    import time
    chunks, deadline = [], time.monotonic() + timeout
    while worker.is_alive() or not queue.empty():
        try:
            chunks.append(queue.get(timeout=0.2))
        except queue_mod.Empty:
            if time.monotonic() > deadline:
                worker.terminate()
                raise TimeoutError("the combine worker did not finish")
    worker.join()
    return chunks


def _tags(chunks):
    m = core.TranscriptModel()
    for c in chunks:
        m.feed(c)
    return m, [core.classify_line(ln) for ln in m.lines]


def test_run_combine_to_queue_matches_combine(tmp_path):
    """The GUI worker on the CPU writes the same output WAV and report,
    byte for byte, as combine() called directly with the same settings,
    and its transcript is combine()'s printed output."""
    import contextlib
    import io
    import queue

    from describealign_tpu_torch import combine
    video_wav, audio_wav = _wav_pair(tmp_path)
    settings = _settings(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        combine([video_wav], [audio_wav], yes=True, device="cpu",
                **settings)
    want = _outputs(tmp_path)
    # the worker writes to the same paths (the report names the output)
    for d in ("out", "plots"):
        os.rename(tmp_path / d, tmp_path / (d + "_direct"))
    q = queue.Queue()
    core.run_combine_to_queue(q, [video_wav], [audio_wav], settings,
                              device="cpu")
    chunks = []
    while not q.empty():
        chunks.append(q.get())
    transcript, tags = _tags(chunks)
    assert "error" not in tags, transcript.text()
    assert _outputs(tmp_path) == want
    assert transcript.text() == _tags([buf.getvalue()])[0].text()


def test_start_worker_runs_combine_in_a_spawned_child(tmp_path):
    video_wav, audio_wav = _wav_pair(tmp_path)
    queue, worker = core.start_worker([video_wav], [audio_wav],
                                      _settings(tmp_path), device="cpu")
    assert isinstance(worker, multiprocessing.context.SpawnProcess)
    assert worker.daemon
    transcript, tags = _tags(_drain(queue, worker))
    assert worker.exitcode == 0
    assert "error" not in tags, transcript.text()
    assert "All files processed." in transcript.lines[-1]
    out = _outputs(tmp_path)
    assert len(out["wav"]) > 1e5 and b"Start Offset:" in out["txt"]


# --- config.ini kept apart from the JAX package's ---------------------------

def test_app_name_differs_from_the_jax_package_s():
    from describealign_tpu import config as jconfig
    from describealign_tpu_torch import config as tconfig
    assert tconfig.APP_NAME == "describealign-tpu-torch"
    assert tconfig.APP_NAME != jconfig.APP_NAME


def test_config_path_leaves_the_jax_config_alone(tmp_path, monkeypatch):
    """With HOME in tmp_path and no platformdirs, the port's config lives
    under its own name and never moves or deletes the JAX package's."""
    import sys

    from describealign_tpu_torch import config as tconfig
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setitem(sys.modules, "platformdirs", None)
    jax_ini = tmp_path / ".config" / "describealign-tpu" / "config.ini"
    jax_ini.parent.mkdir(parents=True)
    jax_ini.write_text("[alignment]\nprepend = jax_\n")
    before = jax_ini.stat().st_mtime_ns
    path = tconfig.get_config_path()
    assert path == (tmp_path / ".config" / "describealign-tpu-torch"
                    / "config.ini")
    m = core.SettingsModel(path)
    assert m.values["prepend"] == "ad_"
    m.set("prepend", "torch_")
    m.save()
    assert tconfig.get_config_path() == path
    assert jax_ini.read_text() == "[alignment]\nprepend = jax_\n"
    assert jax_ini.stat().st_mtime_ns == before
    assert core.SettingsModel(path).values["prepend"] == "torch_"
