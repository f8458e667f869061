"""ffmpeg / ffprobe binary discovery and subprocess runners (a copy of
describealign_tpu/media/ffmpeg.py).

The reference reaches ffmpeg through the ffmpeg-python + static_ffmpeg
packages (describealign.py:124-157, 437-543). Neither is guaranteed here, so
this module locates binaries itself (PATH, env override, static_ffmpeg if
importable) and runs commands through subprocess directly with the same
error-surfacing contract: on failure print "  ERROR: ffmpeg failed to <msg>"
followed by ffmpeg's stderr, then raise.
"""
import os
import shutil
import subprocess

_FFMPEG_PATH = None
_FFPROBE_PATH = None


class FFmpegNotFoundError(RuntimeError):
    pass


def get_static_ffmpeg_version():
    """Installed static_ffmpeg PACKAGE major version (reference
    describealign.py:519-525). Compiled binaries bundle a known-good
    version and skip the check."""
    if "__compiled__" in globals() or getattr(__import__('sys'), 'frozen',
                                              False):
        return 3.0
    import importlib.metadata
    return float(importlib.metadata.version('static_ffmpeg')[:2])


def evict_stale_static_binaries():
    """Force a refetch when static_ffmpeg's cached BINARIES predate ffmpeg
    v6 (reference describealign.py:528-543: the installed.crumb records
    the ffmpeg_bins release the binaries came from; pre-v6 builds lack
    setts features the default mode depends on).

    Returns True when usable (v6+) binaries are already present.
    """
    try:
        import static_ffmpeg.run as sfr
        crumb = os.path.join(sfr.get_platform_dir(), "installed.crumb")
    except Exception:
        return False
    if not os.path.exists(crumb):
        return False
    try:
        with open(crumb) as f:
            line = f.readline()
        version = float(line.split("ffmpeg_bins/raw/main/v")[1].split("/")[0])
    except (IndexError, ValueError, OSError):
        return False
    if version < 6:
        print("Old ffmpeg version detected, updating to newer version...")
        try:
            os.remove(crumb)
        except OSError:
            pass
        return False
    return True


def _fetch_static_ffmpeg():
    """Download binaries via static_ffmpeg (reference 1065-1073 contract:
    requires the package itself to be v3+, evicts pre-v6 binaries)."""
    import static_ffmpeg.run as sfr
    if not evict_stale_static_binaries():
        if get_static_ffmpeg_version() < 3:
            print("  ERROR: outdated static_ffmpeg version")
            raise ImportError("static_ffmpeg must be at least version 3.0")
    return sfr._get_or_fetch_platform_executables_else_raise_no_lock()


def _static_paths_if_installed():
    """(ffmpeg, ffprobe) paths of an EXISTING static_ffmpeg install (crumb
    present, v6+, binaries on disk) without downloading anything; None
    otherwise. The non-fetching half of the reference's is_ffmpeg_installed
    (describealign.py:528-543)."""
    try:
        import static_ffmpeg.run as sfr
        plat_dir = sfr.get_platform_dir()
    except Exception:
        return None
    if not evict_stale_static_binaries():
        return None
    exe = ".exe" if os.name == "nt" else ""
    ffmpeg_bin = os.path.join(plat_dir, "ffmpeg" + exe)
    ffprobe_bin = os.path.join(plat_dir, "ffprobe" + exe)
    if os.path.isfile(ffmpeg_bin) and os.path.isfile(ffprobe_bin):
        return ffmpeg_bin, ffprobe_bin
    return None


def _discover_present(name, env_var):
    """Locate a binary WITHOUT downloading: env override, PATH, or an
    existing static_ffmpeg install."""
    path = os.environ.get(env_var)
    if path and os.path.isfile(path):
        return path
    path = shutil.which(name)
    if path:
        return path
    static = _static_paths_if_installed()
    if static is not None:
        return static[0] if name == 'ffmpeg' else static[1]
    return None


def _discover(name, env_var):
    path = _discover_present(name, env_var)
    if path:
        return path
    try:  # optional: the reference's static_ffmpeg distribution mechanism
        ffmpeg_bin, ffprobe_bin = _fetch_static_ffmpeg()
        return ffmpeg_bin if name == 'ffmpeg' else ffprobe_bin
    except Exception:
        pass
    return None


def _reset_discovery_cache():
    """Testing hook: forget memoized binary paths."""
    global _FFMPEG_PATH, _FFPROBE_PATH
    _FFMPEG_PATH = None
    _FFPROBE_PATH = None


def get_ffmpeg():
    global _FFMPEG_PATH
    if _FFMPEG_PATH is None:
        _FFMPEG_PATH = _discover('ffmpeg', 'DESCRIBEALIGN_FFMPEG')
    if _FFMPEG_PATH is None:
        raise FFmpegNotFoundError(
            "ffmpeg binary not found. Install ffmpeg or set "
            "DESCRIBEALIGN_FFMPEG to its path.")
    return _FFMPEG_PATH


def get_ffprobe():
    global _FFPROBE_PATH
    if _FFPROBE_PATH is None:
        _FFPROBE_PATH = _discover('ffprobe', 'DESCRIBEALIGN_FFPROBE')
    if _FFPROBE_PATH is None:
        raise FFmpegNotFoundError(
            "ffprobe binary not found. Install ffmpeg or set "
            "DESCRIBEALIGN_FFPROBE to its path.")
    return _FFPROBE_PATH


def is_ffmpeg_installed():
    """Non-fetching presence check (reference describealign.py:528-543:
    checks the installed.crumb without downloading; pre-v6 binaries are
    evicted with the same message). Memoized discoveries count as present."""
    if _FFMPEG_PATH is not None and _FFPROBE_PATH is not None:
        return True
    return (_discover_present('ffmpeg', 'DESCRIBEALIGN_FFMPEG') is not None
            and _discover_present('ffprobe',
                                  'DESCRIBEALIGN_FFPROBE') is not None)


def install_ffmpeg_with_prompts():
    """The reference combine()'s interactive install flow (describealign.py:
    1065-1073): static_ffmpeg version floor, download message, fetch,
    post-install re-verification, success print. In an environment without
    static_ffmpeg, raises with the hermetic-env guidance instead."""
    try:
        import static_ffmpeg.run  # noqa: F401
    except ImportError:
        raise RuntimeError(
            "ffmpeg/ffprobe not found. Install ffmpeg or set "
            "DESCRIBEALIGN_FFMPEG / DESCRIBEALIGN_FFPROBE.")
    if get_static_ffmpeg_version() < 3:
        print("  ERROR: outdated static_ffmpeg version")
        raise ImportError("static_ffmpeg must be at least version 3.0")
    print("Downloading and installing ffmpeg (media editor, 50 MB download)...")
    _reset_discovery_cache()
    try:
        get_ffmpeg()
        get_ffprobe()
    except FFmpegNotFoundError:
        pass  # surfaced as the reference's install-failure message below
    if not is_ffmpeg_installed():
        raise RuntimeError("Failed to install ffmpeg.")
    print("Successfully installed ffmpeg.")


def run_ffmpeg_command(args, err_msg, stdin_bytes=None):
    """Run [ffmpeg, *args]; return (stdout, stderr) bytes. Raises on failure."""
    cmd = [get_ffmpeg()] + list(args)
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE if stdin_bytes is not None else None,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = proc.communicate(stdin_bytes)
    if proc.returncode != 0:
        print("  ERROR: ffmpeg failed to " + err_msg)
        print("FFmpeg error:")
        print(err.decode('utf-8', errors='replace'))
        raise ChildProcessError('FFmpeg error.')
    return out, err


def run_ffprobe_json(args, err_msg):
    import json
    cmd = [get_ffprobe(), '-v', 'error', '-print_format', 'json'] + list(args)
    proc = subprocess.run(cmd, capture_output=True)
    if proc.returncode != 0:
        print("  ERROR: ffprobe failed to " + err_msg)
        print(proc.stderr.decode('utf-8', errors='replace'))
        raise ChildProcessError('FFprobe error.')
    return json.loads(proc.stdout.decode('utf-8', errors='replace') or '{}')


def compile_command_line(args):
    """Render an ffmpeg arg list as a loggable command line (report contract:
    reference describealign.py:511-517 logs the exact command, '/'-slashed)."""
    cmd = [get_ffmpeg()] + list(args)
    return subprocess.list2cmdline(cmd).replace('\\', '/')
