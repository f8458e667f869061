"""Command-line interface of the port (describealign_tpu/cli.py's surface):

  describealign-tpu-torch video.mp4 audio.mp3 [--stretch_audio] [--yes]
      [--prepend ad_] [--no_pitch_correction] [--output_dir D]
      [--alignment_dir D] [--install-ffmpeg] [--version] [--warmup MIN]
      [--fit_backend native|device|highs]

The matcher runs on the GPU (CUDA): there is no device flag, and without
CUDA the run fails with an error naming it. --fit_backend device runs the
fit's ADMM on the same GPU. With no arguments the GUI starts (gui/app.py,
when wxPython imports); without wxPython the JAX package's "Can't launch
GUI" message and the usage are printed.
"""
import argparse
import os
import sys

from .constants import DEFAULT_ALIGNMENT_DIR, DEFAULT_OUTPUT_DIR

PROG = 'describealign-tpu-torch'


def command_line_interface(argv=None):
    argv = sys.argv if argv is None else [PROG] + list(argv)
    if len(argv) < 2:
        try:
            from .gui.app import run_gui
        except ImportError:
            run_gui = None
        if run_gui is not None:
            print('No input arguments detected, starting GUI...')
            run_gui()
            sys.exit(0)
        else:
            print("Can't launch GUI and arguments missing.\n"
                  "GUI dependencies missing.")

    parser = argparse.ArgumentParser(
        description="Replaces a video's sound with an audio description.",
        usage=f"{PROG} video_file.mp4 audio_file.mp3")
    parser.add_argument("video", nargs='?', default=None,
                        help='A video file or directory containing video files.')
    parser.add_argument("audio", nargs='?', default=None,
                        help='An audio file or directory containing audio files.')
    parser.add_argument('--stretch_audio', action='store_true',
                        help='Stretches the input audio to fit the input video. '
                             'Default is to stretch the video to fit the audio. '
                             'Keeps original video audio as secondary tracks. '
                             'Slower and uses more RAM when enabled.')
    parser.add_argument('--yes', action='store_true',
                        help='Auto-skips user prompts asking to verify '
                             'information.')
    parser.add_argument("--prepend", default="ad_",
                        help='Output file name prepend text. Default is "ad_"')
    parser.add_argument('--no_pitch_correction', action='store_true',
                        help='Skips pitch correction step when stretching '
                             'audio. Requires --stretch_audio to be set, '
                             'otherwise does nothing.')
    parser.add_argument("--output_dir", default=DEFAULT_OUTPUT_DIR,
                        help='Directory combined output media is saved to. '
                             'Default is "videos_with_ad"')
    parser.add_argument("--alignment_dir", default=DEFAULT_ALIGNMENT_DIR,
                        help='Directory alignment data and plots are saved '
                             'to. Default is "alignment_plots"')
    parser.add_argument("--install-ffmpeg", action="store_true",
                        help="Check/install the required ffmpeg binaries and "
                             "exit (meant for privileged installer processes).")
    parser.add_argument('--version', action='store_true',
                        help='Checks and prints the installed version.')
    parser.add_argument('--warmup', type=float, default=None, metavar='MIN',
                        help='Build the CUDA kernels and the host library '
                             'and exit. MIN is accepted for compatibility '
                             'and not used: the port has no compile cache '
                             'per media length, and the builds are cached '
                             'under build/.')
    parser.add_argument('--fit_backend', default=None,
                        choices=['native', 'device', 'highs'],
                        help='Piecewise-linear fit solver: "native" (exact '
                             'host fused-lasso cascade, default), "device" '
                             '(ADMM on the GPU, falling back to native if '
                             'it does not converge) or "highs" (scipy LP '
                             'cross-check).')
    args = parser.parse_args(argv[1:])

    if args.version:
        _print_version()
    elif args.install_ffmpeg:
        from .media.ffmpeg import get_ffmpeg, get_ffprobe
        os.chmod(get_ffmpeg(), 0o755)
        os.chmod(get_ffprobe(), 0o755)
    elif args.warmup is not None:
        from .alignment.native import native_lib
        from .ops import (coarse_dp, features_kernel, fine_kernel,
                          fit_kernel, pv_kernel)
        for build in (fine_kernel.load_library, coarse_dp.load_library,
                      features_kernel.load_library, fit_kernel.load_library,
                      pv_kernel.load_library, native_lib):
            build()
        print("built the CUDA kernels (fine_match.cu, coarse_dp.cu, "
              "features_dev.cu, fit_admm.cu, pv_lock.cu) and the host "
              "library (dp.cpp, features.cpp).")
    elif args.video and args.audio:
        from . import pipeline
        from .alignment import api
        # the JAX CLI passes the backend through DESCRIBEALIGN_FIT_BACKEND;
        # the port reads no such setting, so it sets the default for the run
        default = api.DEFAULT_FIT_BACKEND
        api.DEFAULT_FIT_BACKEND = args.fit_backend or default
        try:
            pipeline.combine(args.video, args.audio, args.stretch_audio,
                             args.yes, args.prepend, args.no_pitch_correction,
                             args.output_dir, args.alignment_dir)
        finally:
            api.DEFAULT_FIT_BACKEND = default
    else:
        parser.print_usage()


def _print_version():
    """Version and provenance (describealign.py:1820-1840): compiled binary
    / loose source tree / installed package, resolved via find_spec with
    the cwd shadow guard (a checkout in the current directory must not
    mask an installed copy)."""
    import importlib.util

    from . import __version__
    from .utils.hashing import get_version_hash
    print(f"version: {__version__}")
    if "__compiled__" in globals() or getattr(sys, 'frozen', False):
        print("running from compiled binary")
        return
    cur_dir = os.getcwd()
    shadowed = bool(sys.path) and sys.path[0] == cur_dir
    if shadowed:
        del sys.path[0]
    try:
        installed_spec = importlib.util.find_spec('describealign_tpu_torch')
    except (ImportError, ValueError):
        installed_spec = None
    finally:
        if shadowed:
            sys.path.insert(0, cur_dir)
    this_package_path = os.path.dirname(os.path.abspath(__file__))
    installed_path = None
    if installed_spec is not None and installed_spec.origin:
        installed_path = os.path.dirname(
            os.path.abspath(installed_spec.origin))
    if installed_path != this_package_path:
        print("running from downloaded .py file")
    else:
        print("running from installed package")
    print(f"path: {this_package_path}")
    print(f"content hash: {get_version_hash()}")


if __name__ == "__main__":
    command_line_interface()
