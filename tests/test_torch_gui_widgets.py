"""Widget-level tests for the port's wx view layer on a functional wx stub
(the cases of tests/test_gui_widgets.py against
describealign_tpu_torch.gui.app), then the port's own: CombineFrame takes
its queue and process from the spawn context, and building the GUI leaves
CUDA untouched in the parent.

The headless logic lives in gui.core (tested in test_torch_gui_core.py);
this file exercises the event-handler code that remained in gui/app.py -
delete-key removal, drop-target routing, settings enable gating, and the
transcript replace_last text arithmetic - without wxPython or a display,
by instantiating the real classes against small functional stand-ins.
"""
import sys
import types

import pytest


class _WxStub(types.ModuleType):
    """Like test_gui_app_import's stub, but with distinct key constants so
    key-code comparisons are meaningful."""

    _CONSTS = {"WXK_DELETE": 127, "WXK_BACK": 8}

    def __getattr__(self, name):
        if name in self._CONSTS:
            return self._CONSTS[name]
        if name.isupper():
            return 1
        if name[0].isupper():
            return type(name, (), {
                "__init__": lambda self, *a, **k: None,
            })
        raise AttributeError(name)


@pytest.fixture()
def app(monkeypatch):
    import importlib

    stub = _WxStub("wx")
    monkeypatch.setitem(sys.modules, "wx", stub)
    # force a REAL re-import under this stub: `from pkg import app` would
    # short-circuit to the stale module left as a package attribute by an
    # earlier test's import (its stub has different key constants)
    sys.modules.pop("describealign_tpu_torch.gui.app", None)
    app_mod = importlib.import_module("describealign_tpu_torch.gui.app")
    yield app_mod
    sys.modules.pop("describealign_tpu_torch.gui.app", None)
    import describealign_tpu_torch.gui as gui_pkg
    if hasattr(gui_pkg, "app"):
        delattr(gui_pkg, "app")


class FakeListBox:
    def __init__(self, selections=()):
        self.items = []
        self.selections = list(selections)

    def Set(self, items):
        self.items = list(items)

    def GetSelections(self):
        return list(self.selections)


class FakeKeyEvent:
    def __init__(self, code):
        self.code = code
        self.skipped = False

    def GetKeyCode(self):
        return self.code

    def Skip(self):
        self.skipped = True


def _media_list(app, files, selections):
    ml = object.__new__(app.MediaListBox)
    ml.files = list(files)
    ml.listbox = FakeListBox(selections)
    return ml


def test_on_key_delete_removes_selected(app):
    ml = _media_list(app, ["/a/x.mp4", "/a/y.mp4", "/a/z.mp4"], [0, 2])
    ev = FakeKeyEvent(127)                       # WXK_DELETE
    ml._on_key(ev)
    assert ml.files == ["/a/y.mp4"]
    assert ml.listbox.items == ["y.mp4"]         # view refreshed
    assert not ev.skipped


def test_on_key_backspace_also_removes(app):
    ml = _media_list(app, ["/a/x.mp4", "/a/y.mp4"], [1])
    ml._on_key(FakeKeyEvent(8))                  # WXK_BACK
    assert ml.files == ["/a/x.mp4"]


def test_on_key_other_keys_skip(app):
    ml = _media_list(app, ["/a/x.mp4"], [0])
    ev = FakeKeyEvent(65)                        # 'A'
    ml._on_key(ev)
    assert ml.files == ["/a/x.mp4"]              # untouched
    assert ev.skipped                            # event propagates


def test_drop_target_routes_to_add_paths(app, tmp_path):
    f1 = tmp_path / "ep1.mp4"
    f2 = tmp_path / "notes.txt"
    f1.write_bytes(b"")
    f2.write_bytes(b"")
    ml = _media_list(app, [], [])
    ml.extensions = {"mp4"}
    dt = app._DropTarget(ml)
    assert dt.OnDropFiles(0, 0, [str(f1), str(f2)]) is True
    assert ml.files == [str(f1)]                 # filtered by extension
    # duplicates collapse on a second drop
    dt.OnDropFiles(0, 0, [str(f1)])
    assert ml.files == [str(f1)]


class FakeWidget:
    def __init__(self, value):
        self.value = value
        self.enabled = None

    def GetValue(self):
        return self.value

    def Enable(self, flag):
        self.enabled = bool(flag)


def _settings_dialog(app, tmp_path, values):
    from describealign_tpu_torch.gui.core import (SETTINGS_FIELDS,
                                                  SettingsModel)
    dlg = object.__new__(app.SettingsDialog)
    dlg.model = SettingsModel(str(tmp_path / "config.ini"))
    dlg.widgets = {spec["key"]: FakeWidget(values[spec["key"]])
                   for spec in SETTINGS_FIELDS}
    return dlg


def test_refresh_enabled_gates_pitch_on_stretch(app, tmp_path):
    from describealign_tpu_torch.gui.core import SETTINGS_FIELDS
    base = {spec["key"]: (False if spec["kind"] == "bool" else "")
            for spec in SETTINGS_FIELDS}
    dlg = _settings_dialog(app, tmp_path, base)
    dlg._refresh_enabled()
    assert dlg.widgets["no_pitch_correction"].enabled is False
    assert dlg.widgets["stretch_audio"].enabled is True
    # flipping the gate re-enables the dependent field (and _pull pushed
    # the widget values into the model)
    dlg.widgets["stretch_audio"].value = True
    dlg._refresh_enabled()
    assert dlg.model.values["stretch_audio"] is True
    assert dlg.widgets["no_pitch_correction"].enabled is True


class FakeTextCtrl:
    def __init__(self):
        self.buf = ""
        self.styles = []

    def GetNumberOfLines(self):
        return self.buf.count("\n") + 1

    def GetLineLength(self, i):
        return len(self.buf.split("\n")[i])

    def GetLastPosition(self):
        return len(self.buf)

    def Remove(self, a, b):
        self.buf = self.buf[:a] + self.buf[b:]

    def AppendText(self, s):
        self.buf += s

    def SetDefaultStyle(self, attr):
        self.styles.append(attr)


def _combine_frame(app):
    from describealign_tpu_torch.gui.core import TranscriptModel
    frame = object.__new__(app.CombineFrame)
    frame.pal = dict(fg="FG", bg="BG", warn="WARN", err="ERR")
    frame.text = FakeTextCtrl()
    frame.transcript = TranscriptModel()
    return frame


def _feed(frame, chunk):
    for op in frame.transcript.feed(chunk):
        frame._apply(op)


def test_apply_replace_last_overwrites_progress_lines(app):
    frame = _combine_frame(app)
    _feed(frame, "starting\n")
    _feed(frame, "  matching audio...  \r")
    _feed(frame, "  refining match: pass 1 of 2...\r")
    # the progress line was overwritten in place, not appended
    assert frame.text.buf == "starting\n  refining match: pass 1 of 2..."
    _feed(frame, "done\n")
    assert frame.text.buf.startswith("starting\n")
    assert "matching audio" not in frame.text.buf
    assert frame.text.buf.rstrip("\n").endswith("done")


def test_apply_appends_distinct_lines(app):
    frame = _combine_frame(app)
    _feed(frame, "one\ntwo\n")
    assert frame.text.buf.startswith("one\ntwo")


# --- the port's own: a stub on which whole frames build ----------------------

class _Widget:
    """Any widget: every public method accepts anything and returns []."""

    def __init__(self, *a, **k):
        pass

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *a, **k: []


class _FrameStub(_WxStub):
    def __getattr__(self, name):
        if name in self._CONSTS:
            return self._CONSTS[name]
        if name.isupper():
            return 1
        if name[0].isupper():
            return type(name, (_Widget,), {})
        raise AttributeError(name)


@pytest.fixture()
def frame_stub(monkeypatch):
    """wx as _FrameStub, and gui.app / gui.core to be imported afresh
    (the package's core attribute and module are restored afterwards)."""
    import describealign_tpu_torch.gui as gui_pkg
    monkeypatch.setitem(sys.modules, "wx", _FrameStub("wx"))
    if hasattr(gui_pkg, "core"):
        monkeypatch.setattr(gui_pkg, "core", gui_pkg.core)
    for name in ("describealign_tpu_torch.gui.app",
                 "describealign_tpu_torch.gui.core"):
        if name in sys.modules:
            monkeypatch.delitem(sys.modules, name)
    yield
    sys.modules.pop("describealign_tpu_torch.gui.app", None)
    if hasattr(gui_pkg, "app"):
        delattr(gui_pkg, "app")


def test_combine_frame_takes_its_worker_from_the_spawn_context(
        frame_stub, monkeypatch):
    import importlib
    import multiprocessing

    app = importlib.import_module("describealign_tpu_torch.gui.app")
    from describealign_tpu_torch.gui import core
    calls = []

    class FakeProcess:
        def __init__(self, **kw):
            self.kw = kw
            self.started = False

        def start(self):
            self.started = True

    class FakeContext:
        def Queue(self):
            calls.append("Queue")
            return "queue"

        def Process(self, **kw):
            calls.append("Process")
            return FakeProcess(**kw)

    def get_context(method=None):
        calls.append(method)
        return FakeContext()

    monkeypatch.setattr(multiprocessing, "get_context", get_context)
    settings = {"stretch_audio": True}
    frame = app.CombineFrame(None, ["v.wav"], ["a.wav"], settings,
                             app.PALETTE[False])
    assert calls == ["spawn", "Queue", "Process"]
    assert frame.queue == "queue"
    assert frame.worker.started
    assert frame.worker.kw == {
        "target": core.run_combine_to_queue,
        "args": ("queue", ["v.wav"], ["a.wav"], settings),
        "kwargs": {"device": "cuda"}, "daemon": True}


def test_gui_import_and_main_frame_leave_cuda_untouched(
        frame_stub, monkeypatch, tmp_path):
    """The GUI parent never initialises CUDA, so its spawned child (or a
    forked one) could use the card: importing gui.app and gui.core and
    building MainFrame call no CUDA initialisation."""
    import importlib

    import torch
    inits = []
    monkeypatch.setattr(torch.cuda, "_lazy_init",
                        lambda: inits.append("_lazy_init"))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("XDG_CONFIG_HOME", raising=False)
    app = importlib.import_module("describealign_tpu_torch.gui.app")
    importlib.import_module("describealign_tpu_torch.gui.core")
    frame = app.MainFrame()
    assert frame.config_path == (tmp_path / ".config"
                                 / "describealign-tpu-torch" / "config.ini")
    assert frame.videos.files == frame.audios.files == []
    assert inits == []
    assert not torch.cuda.is_initialized()
