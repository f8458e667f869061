"""Import smoke test for the port's wx view layer with a stubbed wx module
(the cases of tests/test_gui_app_import.py against
describealign_tpu_torch.gui.app), then the port's entry points: the CLI
with no arguments starting the GUI, and both console entry points
starting the combiner's spawned child.

wxPython is absent in CI; a minimal stand-in lets the module body (palette
construction, class definitions, schema wiring) execute so name errors and
schema drift are caught without a display.
"""
import sys
import types

import pytest


class _WxStub(types.ModuleType):
    def __getattr__(self, name):
        if name.isupper():          # flag / id constants
            return 1
        if name[0].isupper():       # widget classes
            return type(name, (), {
                "__init__": lambda self, *a, **k: None,
            })
        raise AttributeError(name)


@pytest.fixture()
def stubbed_wx(monkeypatch):
    stub = _WxStub("wx")
    monkeypatch.setitem(sys.modules, "wx", stub)
    sys.modules.pop("describealign_tpu_torch.gui.app", None)
    yield stub
    sys.modules.pop("describealign_tpu_torch.gui.app", None)


def test_app_module_imports_and_wires_schema(stubbed_wx):
    from describealign_tpu_torch.gui import app
    # palette has both modes with all severity colors
    for mode in (True, False):
        assert {"bg", "fg", "accent", "warn", "err"} <= set(
            app.PALETTE[mode])
    # view classes exist and build on the headless core
    for cls in ("MainFrame", "CombineFrame", "SettingsDialog",
                "MediaListBox"):
        assert hasattr(app, cls)
    assert callable(app.run_gui)


def test_is_dark_defaults_false_without_backend(stubbed_wx):
    from describealign_tpu_torch.gui import app
    assert app._is_dark() is False


# --- the port's entry points -------------------------------------------------

def test_cli_without_arguments_starts_the_gui(monkeypatch, capsys):
    from describealign_tpu_torch import cli
    calls = []
    gui_app = types.ModuleType("describealign_tpu_torch.gui.app")
    gui_app.run_gui = lambda: calls.append("run_gui")
    monkeypatch.setitem(sys.modules, "describealign_tpu_torch.gui.app",
                        gui_app)
    with pytest.raises(SystemExit) as exc:
        cli.command_line_interface([])
    assert exc.value.code == 0
    assert calls == ["run_gui"]
    assert capsys.readouterr().out == \
        "No input arguments detected, starting GUI...\n"


# A functional wx stand-in written as a package: every widget accepts any
# call, and App.MainLoop - reached through run_gui after MainFrame is built
# - starts the combiner the way CombineFrame does (gui.core.start_worker),
# on the CPU, drains its queue and prints a JSON summary.
_WX_PACKAGE = '''
import json, os, queue as queue_mod, time


class _Widget:
    def __init__(self, *a, **k):
        pass

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *a, **k: []


class App(_Widget):
    def MainLoop(self):
        import torch
        from describealign_tpu_torch.gui import core
        with open(os.environ["WX_STUB_RUN"]) as f:
            run = json.load(f)
        q, worker = core.start_worker(run["video"], run["audio"],
                                      run["settings"], device="cpu")
        transcript, deadline = core.TranscriptModel(), time.monotonic() + 240
        while worker.is_alive() or not q.empty():
            try:
                transcript.feed(q.get(timeout=0.2))
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    worker.terminate()
                    break
        worker.join()
        print(json.dumps({
            "process": type(worker).__name__, "exitcode": worker.exitcode,
            "tags": [core.classify_line(ln) for ln in transcript.lines],
            "last": transcript.lines[-1] if transcript.lines else "",
            "parent_cuda_initialized": torch.cuda.is_initialized()}))


def __getattr__(name):
    if name.isupper():
        return 1
    if name[0].isupper():
        return type(name, (_Widget,), {})
    raise AttributeError(name)
'''

# pip's console-script wrapper for describealign-tpu-torch, as installed
_CONSOLE_SCRIPT = '''import re
import sys
from describealign_tpu_torch.cli import command_line_interface
if __name__ == "__main__":
    sys.argv[0] = re.sub(r"(-script\\\\.pyw|\\\\.exe)?$", "", sys.argv[0])
    sys.exit(command_line_interface())
'''


@pytest.mark.parametrize("entry", ["python -m", "console script"])
def test_entry_points_start_the_spawned_combiner(entry, tmp_path):
    """`python -m describealign_tpu_torch` and the console script, with no
    arguments, reach run_gui; the combiner child it starts is spawned
    (the child re-imports the entry module under its main guard) and runs
    combine() to the end."""
    import json
    import os
    import subprocess

    from tests.test_torch_gui_core import _settings, _wav_pair
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "stub" / "wx").mkdir(parents=True)
    (tmp_path / "stub" / "wx" / "__init__.py").write_text(_WX_PACKAGE)
    video_wav, audio_wav = _wav_pair(tmp_path)
    run = tmp_path / "run.json"
    run.write_text(json.dumps({"video": [video_wav], "audio": [audio_wav],
                               "settings": _settings(tmp_path)}))
    env = dict(os.environ, HOME=str(tmp_path), WX_STUB_RUN=str(run),
               PYTHONPATH=os.pathsep.join([str(tmp_path / "stub"), repo]))
    env.pop("XDG_CONFIG_HOME", None)
    if entry == "python -m":
        cmd = [sys.executable, "-m", "describealign_tpu_torch"]
    else:
        script = tmp_path / "bin" / "describealign-tpu-torch"
        script.parent.mkdir()
        script.write_text(_CONSOLE_SCRIPT)
        cmd = [sys.executable, str(script)]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "No input arguments detected, starting GUI..."
    got = json.loads(lines[-1])
    assert got["process"] == "SpawnProcess"
    assert got["exitcode"] == 0
    assert "error" not in got["tags"], proc.stdout
    assert got["last"].startswith("All files processed.")
    assert not got["parent_cuda_initialized"]
    assert os.path.getsize(tmp_path / "out" / "ad_film.wav") > 1e5
    # MainFrame resolved the port's own config path under HOME
    assert (tmp_path / ".config" / "describealign-tpu-torch").is_dir()
