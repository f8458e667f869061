"""The controls of the comparison, each put in the program's place, must
come out not correct and the program's sound readings must not: the
reference's score map in TF32 (map_gap), its cascade in bfloat16
(feature_gap) and the true map three frames late (missed_pct), on the CPU
at a cut size and (on the card) at each cell's own size on three seeds."""
import json
import os

import pytest
import torch

import control
from conftest import ROOT, TINY_CELLS
from harness import core


def _limits(cell):
    g = cell.config["guarantees"]
    return {k: g[k + "_limit"] for k in ("map_gap", "margin_gap",
                                         "feature_gap") if k + "_limit" in g}


def _check(cell, r):
    limits = _limits(cell)
    assert r["missed_pct"] <= cell.config["guarantees"]["missed_pct_limit"]
    assert r["control_missed_pct"] == 100.0
    assert {"map_gap", "margin_gap"} <= set(r["control_gaps"])
    for k, limit in limits.items():
        assert max(r["gaps"][k]) <= limit, (k, r["gaps"])
        assert min(r["control_gaps"][k]) > limit, (k, r["control_gaps"])
    if cell.config["level"] == "pcm":
        assert len(r["gaps"]["feature_gap"]) == r["pairs"]


@pytest.mark.parametrize("name", sorted(TINY_CELLS))
def test_controls_fail_and_sound_runs_pass_at_a_cut_size(tiny_root,
                                                         cpu_threads, name):
    cell = core.Cell(tiny_root, name)
    devices = [torch.device("cpu")] * cell.chips
    call = core.program_call(cell, devices)
    _check(cell, control.readings(cell, 17, devices, call, True))


def test_truth_itself_is_correct(tiny_root):
    from harness import gen
    cell = core.Cell(tiny_root, "tiny-episode-batch")
    ref = cell.reference
    for req in gen.make_requests(cell.config, cell.traffic, 3, "cpu"):
        for pair in req:
            nx, ny = ref.control_nodes(pair.segments, 0.0)
            missed, widest = ref.judge(nx, ny, pair.segments, 10.0)
            assert missed == 0.0 and widest < 1e-6


@pytest.mark.cuda
def test_controls_fail_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run there")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w for w in json.load(f)["workloads"]
                 if w["chips"] <= torch.cuda.device_count()]
    for w in cells:
        cell = core.Cell(ROOT, w["name"])
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
        call = core.program_call(cell, devices)
        for seed in (101, 2 ** 31 + 5, 7):
            _check(cell, control.readings(cell, seed, devices, call, True))
