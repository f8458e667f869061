"""wxPython GUI, built declaratively on gui.core (a copy of
describealign_tpu/gui/app.py).

Original implementation for this project. The user-visible behavior
matches the reference app (file pickers with drag-and-drop, a settings
dialog persisted to config.ini, and a combiner window that runs the
pipeline in a child process and live-streams its output with severity
colors and in-place progress lines - see the reference's
describealign.py:1177-1760 for the UX being mirrored),
but the structure is this codebase's own: widgets are generated from the
declarative SETTINGS_FIELDS schema, all stream/severity/file-list logic
lives in the headless, unit-tested gui.core module, and this file is a
thin view layer. The combiner child comes from the 'spawn' context
(gui.core.start_worker), and the pipeline runs there on the card.
"""
import multiprocessing
import os

import wx

from ..config import get_config_path
from .core import (AUDIO_WILDCARD, SETTINGS_FIELDS, VIDEO_WILDCARD,
                   SettingsModel, TranscriptModel, expand_paths,
                   start_worker, validate_selection)
from ..constants import AUDIO_EXTENSIONS, VIDEO_EXTENSIONS

POLL_MS = 120

# one palette, two modes; picked for WCAG-ish contrast on both
PALETTE = {
    True: dict(bg=wx.Colour(24, 26, 31), fg=wx.Colour(222, 226, 235),
               accent=wx.Colour(94, 156, 255),
               warn=wx.Colour(255, 176, 32), err=wx.Colour(255, 92, 92)),
    False: dict(bg=wx.Colour(244, 246, 250), fg=wx.Colour(20, 24, 31),
                accent=wx.Colour(26, 92, 200),
                warn=wx.Colour(176, 104, 0), err=wx.Colour(196, 24, 24)),
}


def _is_dark():
    try:
        return wx.SystemSettings.GetAppearance().IsDark()
    except Exception:
        return False


def _style(window, pal):
    """Apply the palette to a widget tree (checkboxes keep native colors
    for screen-reader/high-contrast friendliness)."""
    stack = [window]
    while stack:
        w = stack.pop()
        if not isinstance(w, wx.CheckBox):
            w.SetBackgroundColour(pal['bg'])
            w.SetForegroundColour(pal['fg'])
        stack.extend(w.GetChildren())


class MediaListBox(wx.Panel):
    """A labeled, drag-and-drop-capable file list with browse/clear."""

    def __init__(self, parent, title, wildcard, extensions, pal):
        super().__init__(parent)
        self.wildcard = wildcard
        self.extensions = extensions
        self.files = []

        box = wx.BoxSizer(wx.VERTICAL)
        box.Add(wx.StaticText(self, label=title), 0, wx.BOTTOM, 4)
        self.listbox = wx.ListBox(self, style=wx.LB_EXTENDED)
        self.listbox.SetToolTip(
            "Drop files or folders here, or use Browse. Press Delete to "
            "remove selected entries.")
        box.Add(self.listbox, 1, wx.EXPAND)
        row = wx.BoxSizer(wx.HORIZONTAL)
        browse = wx.Button(self, label="Browse…")
        clear = wx.Button(self, label="Clear")
        row.Add(browse, 0, wx.RIGHT, 6)
        row.Add(clear, 0)
        box.Add(row, 0, wx.TOP, 6)
        self.SetSizer(box)

        browse.Bind(wx.EVT_BUTTON, self._on_browse)
        clear.Bind(wx.EVT_BUTTON, lambda e: self.set_files([]))
        self.listbox.Bind(wx.EVT_KEY_DOWN, self._on_key)
        self.listbox.SetDropTarget(_DropTarget(self))

    def set_files(self, files):
        self.files = list(files)
        self.listbox.Set([os.path.basename(f) for f in self.files])

    def add_paths(self, paths):
        merged = self.files + expand_paths(paths, self.extensions)
        seen, out = set(), []
        for f in merged:
            if f not in seen:
                seen.add(f)
                out.append(f)
        self.set_files(out)

    def _on_browse(self, _event):
        dlg = wx.FileDialog(self, "Choose files", wildcard=self.wildcard,
                            style=wx.FD_OPEN | wx.FD_MULTIPLE)
        if dlg.ShowModal() == wx.ID_OK:
            self.add_paths(dlg.GetPaths())
        dlg.Destroy()

    def _on_key(self, event):
        if event.GetKeyCode() in (wx.WXK_DELETE, wx.WXK_BACK):
            keep = [f for i, f in enumerate(self.files)
                    if i not in set(self.listbox.GetSelections())]
            self.set_files(keep)
        else:
            event.Skip()


class _DropTarget(wx.FileDropTarget):
    def __init__(self, media_list):
        super().__init__()
        self.media_list = media_list

    def OnDropFiles(self, x, y, filenames):
        self.media_list.add_paths(filenames)
        return True


class SettingsDialog(wx.Dialog):
    """Settings editor generated from the declarative field schema."""

    def __init__(self, parent, model, pal):
        super().__init__(parent, title="Settings")
        self.model = model
        self.widgets = {}

        grid = wx.BoxSizer(wx.VERTICAL)
        for spec in SETTINGS_FIELDS:
            key, kind = spec["key"], spec["kind"]
            if kind == "bool":
                w = wx.CheckBox(self, label=spec["label"])
                w.SetValue(bool(model.values[key]))
                w.Bind(wx.EVT_CHECKBOX, self._refresh_enabled)
                grid.Add(w, 0, wx.ALL, 8)
            else:
                grid.Add(wx.StaticText(self, label=spec["label"]),
                         0, wx.LEFT | wx.TOP, 8)
                w = wx.TextCtrl(self, value=str(model.values[key]),
                                size=(340, -1))
                grid.Add(w, 0, wx.LEFT | wx.RIGHT | wx.BOTTOM | wx.EXPAND, 8)
            w.SetToolTip(spec["help"])
            self.widgets[key] = w

        btns = self.CreateStdDialogButtonSizer(wx.OK | wx.CANCEL)
        grid.Add(btns, 0, wx.ALL | wx.ALIGN_RIGHT, 8)
        self.SetSizerAndFit(grid)
        _style(self, pal)
        self._refresh_enabled()
        self.Bind(wx.EVT_BUTTON, self._on_ok, id=wx.ID_OK)

    def _refresh_enabled(self, _event=None):
        self._pull()
        for spec in SETTINGS_FIELDS:
            self.widgets[spec["key"]].Enable(
                self.model.field_enabled(spec["key"]))

    def _pull(self):
        for spec in SETTINGS_FIELDS:
            self.model.set(spec["key"], self.widgets[spec["key"]].GetValue())

    def _on_ok(self, event):
        self._pull()
        self.model.save()
        event.Skip()


class CombineFrame(wx.Frame):
    """Runs combine() in a child process; streams its output live."""

    def __init__(self, parent, video_files, audio_files, settings, pal):
        super().__init__(parent, title="Combining…", size=(720, 480))
        self.pal = pal
        self.transcript = TranscriptModel()
        self.text = wx.TextCtrl(
            self, style=(wx.TE_MULTILINE | wx.TE_READONLY | wx.TE_RICH2))
        _style(self, pal)
        self.text.SetDefaultStyle(wx.TextAttr(pal['fg'], pal['bg']))

        self.queue, self.worker = start_worker(video_files, audio_files,
                                               settings)

        self.timer = wx.Timer(self)
        self.Bind(wx.EVT_TIMER, self._drain, self.timer)
        self.Bind(wx.EVT_CLOSE, self._on_close)
        self.timer.Start(POLL_MS)

    # --- stream -> text ctrl -------------------------------------------------
    def _drain(self, _event=None):
        while not self.queue.empty():
            for op in self.transcript.feed(self.queue.get()):
                self._apply(op)

    def _apply(self, op):
        if op.kind == "replace_last":
            last = self.text.GetLineLength(self.text.GetNumberOfLines() - 1)
            end = self.text.GetLastPosition()
            self.text.Remove(end - last, end)
            self._write(op)
        else:
            if self.text.GetLastPosition():
                self.text.AppendText("\n")
            self._write(op)

    def _write(self, op):
        color = {"warning": self.pal['warn'],
                 "error": self.pal['err']}.get(op.tag, self.pal['fg'])
        self.text.SetDefaultStyle(wx.TextAttr(color, self.pal['bg']))
        self.text.AppendText(op.text)

    def _on_close(self, event):
        if self.worker.is_alive():
            answer = wx.MessageBox(
                "Processing is still running. Stop it and close?",
                "Still working", wx.YES_NO | wx.ICON_WARNING, self)
            if answer != wx.YES:
                return
            self.worker.terminate()
        self.timer.Stop()
        event.Skip()


class MainFrame(wx.Frame):
    def __init__(self):
        super().__init__(None, title="describealign", size=(640, 520))
        pal = PALETTE[_is_dark()]
        self.config_path = get_config_path()

        root = wx.Panel(self)
        col = wx.BoxSizer(wx.VERTICAL)
        intro = wx.StaticText(
            root, label=("Pair each video with its audio-description "
                         "track, then press Combine."))
        col.Add(intro, 0, wx.ALL, 10)

        self.videos = MediaListBox(
            root, "Videos (or original audio)", VIDEO_WILDCARD,
            VIDEO_EXTENSIONS | AUDIO_EXTENSIONS, pal)
        self.audios = MediaListBox(
            root, "Audio descriptions", AUDIO_WILDCARD, AUDIO_EXTENSIONS,
            pal)
        lists = wx.BoxSizer(wx.HORIZONTAL)
        lists.Add(self.videos, 1, wx.EXPAND | wx.RIGHT, 6)
        lists.Add(self.audios, 1, wx.EXPAND | wx.LEFT, 6)
        col.Add(lists, 1, wx.EXPAND | wx.LEFT | wx.RIGHT, 10)

        row = wx.BoxSizer(wx.HORIZONTAL)
        settings_btn = wx.Button(root, label="Settings…")
        combine_btn = wx.Button(root, label="Combine")
        combine_btn.SetToolTip(
            "Align each pair and write the combined output files.")
        row.Add(settings_btn, 0, wx.RIGHT, 8)
        row.AddStretchSpacer()
        row.Add(combine_btn, 0)
        col.Add(row, 0, wx.EXPAND | wx.ALL, 10)

        root.SetSizer(col)
        _style(self, pal)
        self.pal = pal

        settings_btn.Bind(wx.EVT_BUTTON, self._on_settings)
        combine_btn.Bind(wx.EVT_BUTTON, self._on_combine)

    def _on_settings(self, _event):
        dlg = SettingsDialog(self, SettingsModel(self.config_path), self.pal)
        dlg.ShowModal()
        dlg.Destroy()

    def _on_combine(self, _event):
        problem = validate_selection(self.videos.files, self.audios.files)
        if problem:
            wx.MessageBox(problem, "Can't combine yet",
                          wx.OK | wx.ICON_INFORMATION, self)
            return
        settings = SettingsModel(self.config_path).values
        CombineFrame(self, list(self.videos.files), list(self.audios.files),
                     settings, self.pal).Show()


def run_gui():
    multiprocessing.freeze_support()
    # macOS: the file picker hides its type dropdown unless this option is
    # set before the app starts (reference describealign.py:1781-1782,
    # wxWidgets/Phoenix#2368)
    import platform
    if platform.system() == 'Darwin':
        wx.SystemOptions.SetOption('osx.openfiledialog.always-show-types', 1)
    app = wx.App()
    MainFrame().Show()
    app.MainLoop()
