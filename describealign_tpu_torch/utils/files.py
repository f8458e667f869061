"""File discovery and video<->audio pairing (a copy of
describealign_tpu/utils/files.py).

Behavior contract follows the reference (describealign.py:88-121):
- input may be a file, a directory, or a list of files
- extension whitelist filtering with optional alternate extensions
- natural sort defines pairing order
- flags which "video" inputs actually carry audio extensions
"""
import glob
import os

from .sorting import os_sorted


def ensure_folders_exist(dirs):
    for d in dirs:
        if not os.path.isdir(d):
            print(f"Directory not found, creating it: {d}")
            os.makedirs(d)


def get_sorted_filenames(path, extensions, alt_extensions=frozenset()):
    """Resolve an input spec to a naturally-sorted file list.

    Returns (files, has_alt_extensions) where has_alt_extensions[i] is 1 when
    files[i] matched only via alt_extensions (e.g. an audio file passed in the
    video slot).
    """
    if isinstance(path, (list, tuple)):
        files = [os.path.abspath(str(f)) for f in path]
        for f in files:
            if not os.path.isfile(f):
                raise RuntimeError(f"No file found at input path:\n  {f}")
    else:
        path = os.path.abspath(str(path))
        if os.path.isdir(path):
            files = glob.glob(glob.escape(path) + "/*")
            if not files:
                raise RuntimeError(f"Empty input directory:\n  {path}")
        else:
            if not os.path.isfile(path):
                raise RuntimeError(
                    f"No file or directory found at input path:\n  {path}")
            files = [path]
    allowed = set(extensions) | set(alt_extensions)
    files = [f for f in files if os.path.splitext(f)[1][1:].lower() in allowed]
    if not files:
        error_msg = [
            f"No files with valid extensions found at input path:\n  {path}",
            "Did you accidentally put the audio filepath before the video filepath?",
            "The video path should be the first positional input, audio second.",
            "Or maybe you need to add a new extension to this script's regex?",
            f"valid extensions for this input are:\n  {extensions}",
        ]
        raise RuntimeError("\n".join(error_msg))
    files = os_sorted(files)
    has_alt = [0 if os.path.splitext(f)[1][1:].lower() in extensions else 1
               for f in files]
    return files, has_alt
