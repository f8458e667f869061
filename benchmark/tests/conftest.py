"""Shared set-up of the benchmark's own tests: the benchmark and the
checkout on sys.path, the card marker, and a temporary checkout that holds
a copy of the benchmark with tiny cells beside the real ones.

Run them from the checkout's root:  python -m pytest benchmark/tests -q
"""
import copy
import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny layouts of the real configurations' kinds: plain inserts, a slowed
# description, a feature-level film
TINY_PLAIN = {"content_s": 60.0, "kind": "plain", "pieces": [
    ["narration", 8.0], ["content", 0.0, 25.0], ["narration", 3.0],
    ["content", 25.0, 60.0]]}
TINY_RATE = {"content_s": 60.0, "kind": "rate", "pieces": [
    ["narration", 5.0], ["content", 0.0, 60.0, [103, 100]],
    ["narration", 4.0]]}
TINY_FILM = {"content_frames": 12600, "kind": "film", "pieces": [
    ["narration", 1000], ["content", 0, 6000], ["narration", 630],
    ["content", 6000, 12600]]}
TINY_CELLS = {
    "tiny-episode-single": ("tiny_pcm", "interactive_single", 1,
                            "episode-single"),
    "tiny-film-single": ("tiny_film", "interactive_single", 1,
                         "film-single"),
    "tiny-episode-batch": ("tiny_pcm", "library_batch8", 1,
                           "episode-batch8"),
    "tiny-episode-mesh": ("tiny_pcm", "library_batch8_mesh", 2,
                          "episode-batch8-4gpu"),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is "
        "unavailable (run these on the card)")


def make_tiny_checkout(dest):
    """A checkout at dest with a copy of benchmark/ and a BENCHMARK.json
    that adds tiny configurations and one tiny cell beside each real
    cell, with the same metrics."""
    shutil.copytree(BENCH_DIR, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg_dir = os.path.join(dest, "benchmark", "configs")
    real = {c["name"]: c for c in bench["configs"]}
    for name, src, layouts in (
            ("tiny_pcm", "tv_episode_22min",
             {"single": [TINY_PLAIN], "batch8": [TINY_PLAIN, TINY_RATE]}),
            ("tiny_film", "feature_film_95min", {"single": [TINY_FILM]})):
        with open(os.path.join(ROOT, real[src]["file"])) as f:
            cfg = json.load(f)
        cfg["name"], cfg["layouts"] = name, layouts
        with open(os.path.join(cfg_dir, name + ".json"), "w") as f:
            json.dump(cfg, f)
        entry = copy.deepcopy(real[src])
        entry.update(name=name, file=f"benchmark/configs/{name}.json")
        bench["configs"].append(entry)
    for cell, (cfg, traffic, chips, like) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": traffic, "chips": chips,
                                   "why": "a tiny copy of " + like})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_checkout(str(tmp_path))


@pytest.fixture
def cpu_threads():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)
