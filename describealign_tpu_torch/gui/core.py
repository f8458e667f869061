"""Headless GUI logic: everything the wx layer needs that isn't a widget (a
copy of describealign_tpu/gui/core.py).

Original design for this project (the behavior contract - a combiner child
process streaming prints through a queue, carriage-return progress lines
overwriting in place, WARNING/ERROR severity colorization, settings
persisted to config.ini - follows the reference UX at
describealign.py:1358-1491, but the code is not derived from it). Keeping
this module free of wx makes the whole pipeline-facing surface
unit-testable in environments without a display or wxPython.

The port's combiner child is started from the 'spawn' context
(start_worker), not by fork: CUDA cannot be used in a forked child once
the parent has touched it.
"""
import io
import multiprocessing
import os
import traceback
from dataclasses import dataclass, field

from ..config import read_config_file, write_config_file
from ..constants import AUDIO_EXTENSIONS, VIDEO_EXTENSIONS
from ..utils.sorting import natural_key

# severity protocol: combine() prefixes these to lines it prints
SEVERITY_PREFIXES = (
    ("  ERROR:", "error"),
    ("  WARNING:", "warning"),
)


def classify_line(line):
    """Return 'error' / 'warning' / None for a printed pipeline line."""
    for prefix, tag in SEVERITY_PREFIXES:
        if line.startswith(prefix):
            return tag
    return None


@dataclass
class TextOp:
    """One mutation the transcript view must apply.

    kind: 'append' (add text at the end) or 'replace_last' (overwrite the
    final line). tag carries the severity for colorization (or None).
    """
    kind: str
    text: str
    tag: str = None


@dataclass
class TranscriptModel:
    """State machine turning raw pipeline output into view operations.

    Progress lines end with '\r' and are overwritten in place by whatever
    comes next (matching terminal behavior, so the GUI shows a live
    progress line instead of thousands of stacked ones). Chunks may split
    arbitrarily - print() alone issues separate writes for the text and
    the line terminator - so an unterminated tail stays 'open' and later
    text merges into the same visual line.
    """
    lines: list = field(default_factory=list)
    _open: bool = field(default=False)       # last line still growing
    _overwrite: bool = field(default=False)  # next text replaces last line

    def feed(self, chunk):
        """Consume one stdout chunk; return the list of TextOps to apply."""
        import re
        ops = []
        for seg in re.split(r'([\r\n])', chunk):
            if seg == '':
                continue
            if seg == '\n':
                if not self._open:
                    self.lines.append('')
                    ops.append(TextOp('append', '', None))
                self._open = False
                self._overwrite = False
            elif seg == '\r':
                self._overwrite = True
            else:
                if self._overwrite and self.lines:
                    self.lines[-1] = seg
                    ops.append(TextOp('replace_last', seg,
                                      classify_line(seg)))
                elif self._open and self.lines:
                    self.lines[-1] += seg
                    merged = self.lines[-1]
                    ops.append(TextOp('replace_last', merged,
                                      classify_line(merged)))
                else:
                    self.lines.append(seg)
                    ops.append(TextOp('append', seg, classify_line(seg)))
                self._open = True
                self._overwrite = False
        return ops

    def text(self):
        return "\n".join(self.lines)


class QueueWriter(io.TextIOBase):
    """File-like stdout replacement that forwards writes to a queue."""

    def __init__(self, queue):
        self.queue = queue

    def write(self, s):
        if s:
            self.queue.put(s)
        return len(s)

    def writable(self):
        return True

    def flush(self):
        pass


def run_combine_to_queue(queue, video_files, audio_files, settings,
                         device='cuda'):
    """Child-process entry: run combine() on `device` with stdout/stderr
    redirected to the queue; exceptions are formatted into the stream so
    the UI can show them instead of a silently dead worker."""
    import contextlib

    from ..pipeline import combine

    writer = QueueWriter(queue)
    with contextlib.redirect_stdout(writer), \
            contextlib.redirect_stderr(writer):
        try:
            combine(video_files, audio_files, yes=True,
                    stretch_audio=settings['stretch_audio'],
                    prepend=settings['prepend'],
                    no_pitch_correction=settings['no_pitch_correction'],
                    output_dir=settings['output_dir'],
                    alignment_dir=settings['alignment_dir'],
                    device=device)
        except BaseException:
            print("\n  ERROR: processing failed\n")
            print(traceback.format_exc())


def start_worker(video_files, audio_files, settings, device='cuda'):
    """Start run_combine_to_queue in a daemon child process; returns its
    (queue, process), both from the 'spawn' context: a forked child could
    not use CUDA once the parent had touched it."""
    ctx = multiprocessing.get_context('spawn')
    queue = ctx.Queue()
    worker = ctx.Process(target=run_combine_to_queue,
                         args=(queue, video_files, audio_files, settings),
                         kwargs={'device': device}, daemon=True)
    worker.start()
    return queue, worker


# --- settings schema ---------------------------------------------------------
# one declarative row per combine() kwarg the GUI exposes; the wx layer
# builds widgets from this table instead of wiring by widget class name

SETTINGS_FIELDS = (
    {"key": "stretch_audio", "kind": "bool",
     "label": "Replace audio track (stretch mode)",
     "help": ("Write a new default audio track with the description "
              "time-stretched onto the original sound, instead of "
              "retiming video frames.")},
    {"key": "no_pitch_correction", "kind": "bool",
     "label": "Plain resampling (no pitch correction)",
     "help": ("Stretch by resampling alone; faster but audibly shifts "
              "pitch on larger rate changes. Only used in stretch mode."),
     "enabled_by": "stretch_audio"},
    {"key": "prepend", "kind": "str",
     "label": "Output name prefix",
     "help": "Text placed before each output file's name."},
    {"key": "output_dir", "kind": "path",
     "label": "Output folder",
     "help": "Where combined media files are written."},
    {"key": "alignment_dir", "kind": "path",
     "label": "Alignment report folder",
     "help": "Where alignment plots and text reports are written."},
)


class SettingsModel:
    """Load/validate/save the 5 persisted combine() settings."""

    def __init__(self, config_path):
        self.config_path = str(config_path)
        self.values = read_config_file(self.config_path)

    def set(self, key, value):
        if key not in self.values:
            raise KeyError(key)
        self.values[key] = value

    def field_enabled(self, key):
        spec = next(f for f in SETTINGS_FIELDS if f["key"] == key)
        gate = spec.get("enabled_by")
        return bool(self.values[gate]) if gate else True

    def save(self):
        write_config_file(self.config_path, self.values)


# --- file list model ---------------------------------------------------------

def expand_paths(paths, extensions):
    """Dropped/browsed paths -> flat, naturally sorted, filtered file list.

    Directories are walked one level (like dropping a season folder);
    files are kept when their extension matches.
    """
    out = []
    for p in paths:
        if os.path.isdir(p):
            for name in os.listdir(p):
                full = os.path.join(p, name)
                if os.path.isfile(full) and _ext_ok(name, extensions):
                    out.append(full)
        elif _ext_ok(p, extensions):
            out.append(p)
    return sorted(out, key=natural_key)


def _ext_ok(name, extensions):
    return os.path.splitext(name)[1].lower().lstrip('.') in extensions


def wildcard_for(extensions, label):
    """A file-dialog wildcard string for a set of extensions."""
    pats = ';'.join(f"*.{e}" for e in sorted(extensions))
    return f"{label} ({pats})|{pats}|All files (*.*)|*.*"


def validate_selection(video_files, audio_files):
    """Return an error message for the main frame, or None if runnable."""
    if not video_files and not audio_files:
        return "Choose video and audio description files first."
    if not video_files:
        return "Choose the video files to combine."
    if not audio_files:
        return "Choose the audio description files to combine."
    if len(video_files) != len(audio_files):
        return (f"File counts differ: {len(video_files)} video vs "
                f"{len(audio_files)} audio description files.")
    return None


VIDEO_WILDCARD = wildcard_for(VIDEO_EXTENSIONS | AUDIO_EXTENSIONS,
                              "Media files")
AUDIO_WILDCARD = wildcard_for(AUDIO_EXTENSIONS, "Audio files")
