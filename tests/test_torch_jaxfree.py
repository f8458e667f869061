"""The port runs where jax is absent: the card machine has no jax,
sortedcontainers, matplotlib or platformdirs, and the port imports nothing
of the JAX package. A subprocess blocks those modules and the JAX package
and runs the port's align_from_pcm (both feature paths, the mel frontend),
features_for, sequence-sharded features, the batch (with and without a
device list; the coarse score map's and the DP's wrappers), the device
fit, phase vocoder and resampler, then combine() (with the device stretch
backends) and the CLI's --version, on a small pair on the CPU; then the
config and the GUI's headless core (the fallback path without
platformdirs), music_bed and a campaign case, and the dryrun twin
(scripts/torch_dryrun_multichip.py) on two CPU devices.
chip_smoke.py imports only the port, torch and numpy."""
import ast
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "sortedcontainers", "matplotlib", "platformdirs",
           "describealign_tpu")

_SCRIPT = f"""
import sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
import numpy as np
from describealign_tpu_torch import align_from_pcm
from describealign_tpu_torch.alignment.native import native_lib
from describealign_tpu_torch.bench_pair import build_scale_pair
from describealign_tpu_torch.utils.synthmedia import build_pair
video, audio, _ = build_pair(content_seconds=14.0, narration=(),
                             lead_in=2.0, seed=3)
v = np.clip(video, -32768, 32767).astype(np.int16)
a = np.clip(audio, -32768, 32767).astype(np.int16)
out = align_from_pcm(v, a, device="cpu")
assert len(out) == 6, len(out)
assert abs(float(out[0][0] - out[1][0]) - 2.0) < 0.05, out[0][0] - out[1][0]

# the device-feature path (the feature kernels' plain versions on the CPU)
from describealign_tpu_torch import features_for
from describealign_tpu_torch.ops import features_kernel
dev = align_from_pcm(v, a, device="cpu", features="device")
assert len(dev) == 6 and abs(float(dev[0][0] - dev[1][0]) - 2.0) < 0.05
feats, n_frames = features_for(a, device="cpu")
assert len(feats) == 5 and n_frames == a.shape[1] // 210
assert (features_kernel.pcm_frontend_cuda.launches
        == features_kernel.polyphase_blur_cuda.launches == 0)

# the batch path and the coarse-DP wrappers (plain versions on the CPU)
from describealign_tpu_torch import align_batch_from_pcm
from describealign_tpu_torch.bench_pair import BATCH_SPECS, build_batch_pairs
from describealign_tpu_torch.ops import coarse_dp
both = align_batch_from_pcm([(v, a), (v, a)], device="cpu")
assert all(np.array_equal(r[0], dev[0]) for r in align_batch_from_pcm(
    [(v, a), (v, a)], device="cpu", features="device"))
assert len(both) == 2 and all(len(r) == 6 for r in both)
for r in both:
    assert np.array_equal(r[0], out[0]) and np.array_equal(r[1], out[1])
assert len(BATCH_SPECS) == 8
assert coarse_dp.dp_forward.launches == coarse_dp.dp_backtrace.launches == 0
# the coarse score map's wrapper (the plain version on the CPU)
from describealign_tpu_torch.ops import coarse_map
assert coarse_map.block_scores.launches == 0

# the mel frontend, sequence-sharded features, the data-parallel batch
from describealign_tpu_torch.parallel.seqshard import sequence_sharded_features
from describealign_tpu_torch.pipeline import _auto_mesh
mel = align_from_pcm(v, a, device="cpu", frontend="mel")
assert abs(float(mel[0][0] - mel[1][0]) - 2.0) < 0.05
feats, _ = features_for(a, device="cpu", frontend="mel")
assert len(feats) == 5
s = a.shape[1] - a.shape[1] % (210 * 4)
assert sequence_sharded_features(a[:, :s], ["cpu"] * 4).shape == (5, s // 210)
dp = align_batch_from_pcm([(v, a), (v, a)], device="cpu", mesh=["cpu"] * 2)
assert len(dp) == 2 and all(len(r) == 6 for r in dp)
assert _auto_mesh() is None

# the output side's device backends (their plain versions on the CPU)
from describealign_tpu_torch.alignment.fit import solve_l1_fit
from describealign_tpu_torch.ops import fit_kernel, pv_kernel
from describealign_tpu_torch.stretch.phase_vocoder import pv_stretch
from describealign_tpu_torch.stretch.resample import resample_segment
xs = np.cumsum(np.full(40, 100.0))
fit = solve_l1_fit(xs, xs * 1.01 + 5.0, backend="device", device="cpu")
assert abs(fit["median_slope"] - 1.01) < 1e-3, fit["median_slope"]
seg = np.random.default_rng(0).standard_normal((2, 88200)).astype(
    np.float32) * 1000
for backend in ("host", "device"):
    assert pv_stretch(seg, 90000, backend=backend,
                      device="cpu").shape == (2, 90000)
    assert resample_segment(seg, 0, 88200, 90000, backend=backend,
                            device="cpu").shape == (2, 90000)
assert fit_kernel.fused_lasso_admm.launches == 0
assert pv_kernel.pv_phase_lock.launches == 0

# combine() in stretch mode on a WAV pair: the .txt report, no .png, and
# one WARNING line naming matplotlib; then the CLI's --version
import contextlib, io, os, tempfile
from describealign_tpu_torch import combine
from describealign_tpu_torch.cli import command_line_interface
from describealign_tpu_torch.media.decode import write_wav
tmp = tempfile.mkdtemp()
write_wav(os.path.join(tmp, "film.wav"), np.tile(v, (2, 1)))
write_wav(os.path.join(tmp, "desc.wav"), np.tile(a, (2, 1)))
with contextlib.redirect_stdout(io.StringIO()) as buf:
    combine([os.path.join(tmp, "film.wav")], [os.path.join(tmp, "desc.wav")],
            stretch_audio=True, yes=True, output_dir=os.path.join(tmp, "o"),
            alignment_dir=os.path.join(tmp, "p"), device="cpu",
            stretcher="pv", pv_backend="device", resample_backend="device")
    command_line_interface(["--version"])
printed = buf.getvalue()
warned = [ln for ln in printed.splitlines()
          if "WARNING" in ln and "matplotlib" in ln]
assert len(warned) == 1, printed
assert "Start Offset:" in open(os.path.join(tmp, "p", "film.txt")).read()
assert not os.path.exists(os.path.join(tmp, "p", "film.png"))
assert os.path.getsize(os.path.join(tmp, "o", "ad_film.wav")) > 1e5
assert "version: " in printed and "content hash: " in printed, printed

# the config and the GUI's headless core (platformdirs is blocked, so the
# ~/.config fallback), music_bed, a campaign case, the dryrun twin
import runpy
from describealign_tpu_torch import config
from describealign_tpu_torch.bench_pair import build_campaign_case
from describealign_tpu_torch.gui import core
from describealign_tpu_torch.utils.synthmedia import music_bed
os.environ["HOME"] = tmp
path = config.get_config_path()
assert path == config.Path(tmp) / ".config" / "describealign-tpu-torch" / \
    "config.ini", path
assert core.SettingsModel(path).values["prepend"] == "ad_"
assert path.exists()
bed = music_bed(2.0, seed=577)
assert bed.shape == (88200,) and np.isfinite(bed).all()
# (a case without scipy's resample_poly: scipy probes sys.modules["jax"],
# which the blocking above sets to None)
pv, pa = build_campaign_case("music_bed_short_segments")
assert pv.dtype == pa.dtype == np.int16 and pa.shape[1] > pv.shape[1]
twin = runpy.run_path(os.path.join("scripts", "torch_dryrun_multichip.py"))
dry = twin["dryrun"](["cpu"] * 2)
assert all(dry["interior"].values()) and dry["candidates"] > 0
loaded = [m for m in sys.modules
          if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
assert not loaded, loaded
print("JAXFREE_OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "JAXFREE_OK" in proc.stdout


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "describealign_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_chip_smoke_imports_only_the_port():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, node.module
            names.add(node.module)
    tops = {n.split(".")[0] for n in names}
    assert "describealign_tpu_torch" in tops
    assert tops <= {"describealign_tpu_torch", "torch", "numpy", "contextlib",
                    "hashlib", "io", "json", "os", "queue", "shutil",
                    "subprocess", "sys", "tempfile", "threading", "time",
                    "warnings", "wave"}, tops


def _imported_tops(path):
    """Top-level names of every module `path` imports (relative imports
    resolve inside their own package and are skipped)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_port_never_imports_the_jax_package():
    """No module of the port, nor chip_smoke.py, nor the card tests, names
    the JAX package as an import (the top-level name, not a prefix:
    describealign_tpu_torch is the port itself)."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "test_torch_cuda.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "describealign_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        assert "describealign_tpu" not in _imported_tops(path), path
