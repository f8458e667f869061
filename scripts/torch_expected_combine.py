#!/usr/bin/env python
"""Write the JAX package's combine() result on the bench pair's WAVs, the
fixture that chip_smoke.py phase 4 holds the port's CLI against.

Writes the bench pair (describealign_tpu_torch.bench_pair: 22-min video,
27-min description, int16 mono) as 16-bit WAVs into a temporary
directory, runs `describealign_tpu.combine(..., stretch_audio=True)` on
them (JAX, CPU backend; the built-in WAV codec, no ffmpeg) and records in
tests/data/torch_combine_expected.json: the printed progress and WARNING
lines (split at every \\r and \\n, the run directory written <run>, without
the `Processing files with v...` line), the .txt report's lines without
`Version:` and `Script Hash:`, and the output WAV's channels and sample
count.

Run from the repo root (a few minutes on a CPU):

    python scripts/torch_expected_combine.py
"""
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import wave

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_combine_expected.json")
VIDEO, AUDIO = "bench_video.wav", "bench_audio.wav"


def printed_lines(text, run_dir):
    """The printed segments as the fixture keeps them."""
    return [s.replace(run_dir, "<run>") for s in text.splitlines()
            if not s.startswith("Processing files with v")]


def report_lines(path, run_dir):
    with open(path) as f:
        return [s.replace(run_dir, "<run>") for s in f.read().splitlines()
                if not s.startswith(("Version:", "Script Hash:"))]


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")

    import describealign_tpu as da
    from describealign_tpu_torch.bench_pair import build_scale_pair
    from describealign_tpu_torch.media.decode import write_wav

    v, a = build_scale_pair(os.path.join(REPO, "build", "bench_pair_i16.npz"))
    with tempfile.TemporaryDirectory() as run_dir:
        write_wav(os.path.join(run_dir, VIDEO), v)
        write_wav(os.path.join(run_dir, AUDIO), a)
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            da.combine([os.path.join(run_dir, VIDEO)],
                       [os.path.join(run_dir, AUDIO)], stretch_audio=True,
                       yes=True, output_dir=os.path.join(run_dir, "out"),
                       alignment_dir=os.path.join(run_dir, "plots"))
        combine_s = time.time() - t0
        with wave.open(os.path.join(run_dir, "out", "ad_" + VIDEO)) as w:
            channels, frames = w.getnchannels(), w.getnframes()
        result = {
            "source": "describealign_tpu.combine(stretch_audio=True) (JAX, "
                      "CPU backend) on describealign_tpu_torch.bench_pair "
                      "written as 16-bit WAVs",
            "video_wav": VIDEO,
            "audio_wav": AUDIO,
            "video_samples": int(v.shape[1]),
            "output_channels": channels,
            "output_samples": frames,
            "printed": printed_lines(buf.getvalue(), run_dir),
            "report": report_lines(os.path.join(run_dir, "plots",
                                                "bench_video.txt"), run_dir),
            "combine_seconds_cpu": round(combine_s, 1),
        }
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(json.dumps({k: result[k] for k in (
        "output_channels", "output_samples", "combine_seconds_cpu")}))
    print("\n".join(result["report"][:6]))


if __name__ == "__main__":
    main()
