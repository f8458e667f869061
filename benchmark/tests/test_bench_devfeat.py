"""The film from its PCM on the device-feature route (film-pcm-devfeat):
its configuration, traffic, reference and metrics are found by name, and
the reference, which imports nothing of the program, judges the score-map
rows that the route makes from its own features, each track at its own
width, on the CPU with a cut copy of the configuration (60 s of content,
so the video takes one bucket and the description two): sound readings
pass, each control fails, the reference's plain stacks are the route's,
and a whole run with the route's features rounded to bfloat16 inside the
timed path comes out not correct."""
import copy
import json
import os
import time

import pytest
import torch

import control
from conftest import ROOT, make_tiny_checkout
from harness import core

CELL = "film-pcm-devfeat"
TINY = "tiny-film-pcm-devfeat"
TINY_LAYOUT = {"content_s": 60.0, "kind": "film", "pieces": [
    ["narration", 6.0], ["content", 0.0, 30.0], ["narration", 3.0],
    ["content", 30.0, 60.0]]}
METRICS = ("features.stage_s", "features_dev.roofline",
           "features.device_pct")
# the single cells' metrics that read this cell too
SHARED = ("features_s", "coarse_s", "fine_s", "lis_tail_s",
          "device_idle.single", "peak_mem_gib", "coarse_score_map.roofline",
          "tail.lis_s", "tail.pass1_s", "tail.pass2_s",
          "tail.retry_pct.single")
# of those, the ones a CPU run reads (no card: no peak, no roofline)
ON_CPU = ("features_s", "coarse_s", "fine_s", "lis_tail_s", "tail.lis_s",
          "tail.pass1_s", "tail.pass2_s", "tail.retry_pct.single")


@pytest.fixture(scope="module")
def devfeat_root(tmp_path_factory):
    """A tiny checkout with a cut copy of the cell beside the real ones."""
    root = make_tiny_checkout(str(tmp_path_factory.mktemp("devfeat")))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    real = next(c for c in bench["configs"]
                if c["name"] == "feature_film_95min_pcm_devfeat")
    with open(os.path.join(ROOT, real["file"])) as f:
        cfg = json.load(f)
    cfg["name"], cfg["layouts"] = "tiny_film_pcm", {"single": [TINY_LAYOUT]}
    with open(os.path.join(root, "benchmark", "configs",
                           "tiny_film_pcm.json"), "w") as f:
        json.dump(cfg, f)
    entry = copy.deepcopy(real)
    entry.update(name="tiny_film_pcm",
                 file="benchmark/configs/tiny_film_pcm.json")
    bench["configs"].append(entry)
    bench["workloads"].append({"name": TINY, "config": "tiny_film_pcm",
                               "traffic": "interactive_single_devfeat",
                               "chips": 1, "why": "a tiny copy of " + CELL})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root


def _run(root, seconds=1.0, seed=2 ** 31 + 77, trace=0):
    cell = core.Cell(root, TINY)
    return core.execute(cell, seed, seconds, trace, [torch.device("cpu")],
                        "cpu", time.time())


def test_the_cell_is_found_by_name():
    cell = core.Cell(ROOT, CELL)
    assert cell.chips == 1
    assert cell.traffic["entry_kwargs"] == {"features": "device"}
    assert cell.config["level"] == "pcm"
    assert cell.config["margin_reference"] == "coarse_plain_devfeat"
    assert hasattr(cell.margin_reference, "compare")
    assert [m["name"] for m in cell.end_to_end] == ["align_s", "setup_s"]
    named = {m["name"]: m for m in cell.per_layer}
    assert set(named) == set(METRICS) | set(SHARED)
    for name in named:
        assert hasattr(cell.reader(named[name]), "read"), name
        assert named[name]["moves"] == "align_s"


def test_the_layout_is_the_films():
    """5,700 s of content in 13 pieces at the feature-level film's frame
    boundaries, a 202-s lead-in and 12 inserts of 15 s: 6,082 s."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "feature_film_95min.json")) as f:
        film = json.load(f)["layouts"]["single"][0]["pieces"]
    cell = core.Cell(ROOT, CELL)
    pcm = cell.config["layouts"]["single"][0]["pieces"]
    assert len(pcm) == len(film) == 26
    for p, f in zip(pcm, film):
        assert p[0] == f[0]
        assert p[1:] == [x / 210 for x in f[1:]]
    assert sum(p[1] if p[0] == "narration" else p[2] - p[1]
               for p in pcm) == pytest.approx(6082.0)


def test_compare_reads_the_routes_own_map_rows(devfeat_root, cpu_threads):
    cell = core.Cell(devfeat_root, TINY)
    devices = [torch.device("cpu")]
    call = core.program_call(cell, devices)
    r = control.readings(cell, 23, devices, call, True)
    g = cell.config["guarantees"]
    assert r["missed_pct"] <= g["missed_pct_limit"]
    # the route's stacks are not seen: only its map rows are compared
    assert set(r["gaps"]) == set(r["control_gaps"]) == {"map_gap"}
    assert len(r["gaps"]["map_gap"]) == 1
    assert max(r["gaps"]["map_gap"]) <= g["map_gap_limit"]
    # the nearer of the controls (the map in TF32, the cascade in bfloat16)
    assert min(r["control_gaps"]["map_gap"]) > g["map_gap_limit"]
    assert r["control_missed_pct"] == 100.0


@pytest.mark.parametrize("which", ["tf32", "bfloat16"])
def test_each_control_fails_alone(devfeat_root, which):
    from harness import gen
    cell = core.Cell(devfeat_root, TINY)
    ref = cell.margin_reference
    pair = gen.make_requests(cell.config, cell.traffic, 7, "cpu")[0][0]
    cpu = torch.device("cpu")
    plain = ref.Pair(pair, cpu)
    b0, m = 2, 8
    want = plain.rows(b0, m)
    if which == "tf32":
        got = plain.rows(b0, m, tf32=True)
    else:
        got = ref.Pair(pair, cpu, torch.bfloat16).rows(b0, m)
    limit = cell.config["guarantees"]["map_gap_limit"]
    assert ref.map_gap(got, want) > limit
    assert ref.map_gap(plain.rows(b0, m), want) == 0.0


def test_stacks_at_their_own_widths(devfeat_root):
    """The reference's plain stacks are the route's own (matching.
    extract_and_match on the PCM as alignment/api.py uploads it) within
    the configuration's feature_gap_limit, each track at its own width,
    zero past its true frames."""
    from harness import gen
    from describealign_tpu_torch.alignment import api, matching
    cell = core.Cell(devfeat_root, TINY)
    ref = cell.margin_reference
    cpu = torch.device("cpu")
    pair = gen.make_requests(cell.config, cell.traffic, 5, "cpu")[0][0]
    nv, na = pair.frames()
    out = matching.extract_and_match(
        api._pcm_to_device(pair.audio, cpu), na,
        api._pcm_to_device(pair.video, cpu), nv)
    route = {"audio": out[3], "video": out[4]}
    limit = cell.config["guarantees"]["feature_gap_limit"]
    widths = []
    for name, pcm, n in (("video", pair.video, nv), ("audio", pair.audio,
                                                     na)):
        mine = ref.plain_stack(pcm, n, cpu)
        assert mine.shape == (3, ref.padded_len(pcm.shape[1]) // 210)
        assert mine.dtype == torch.float32
        assert bool((mine[:, n:] == 0).all())
        assert bool((mine[0, :n] > 0).any())
        theirs = route[name][:3]
        assert theirs.shape == mine.shape
        gap = ((theirs - mine).abs().amax(dim=1)
               / mine.abs().amax(dim=1)).max()
        assert float(gap) <= limit, name
        widths.append(mine.shape[1])
    assert widths[0] != widths[1]


def test_sound_traced_run(devfeat_root, cpu_threads):
    _, res = _run(devfeat_root, trace=1)
    assert res["correct"], res["checks"]
    c = res["checks"]
    assert c["map_gap"]["value"] <= c["map_gap"]["limit"] == 2e-5
    assert "feature_gap" not in c
    m = res["metrics"]
    assert m["features.device_pct"]["value"] == 100.0
    assert m["features.stage_s"]["value"] > 0.0
    assert m["tail.retry_pct.single"]["value"] == 0.0
    for name in ON_CPU:
        assert name in m, name
    # no card, no kernel launch to read
    assert "features_dev.roofline" not in m
    assert "coarse_score_map.roofline" not in m


def _bf16_features(monkeypatch):
    """feature_stack's output rounded to bfloat16 (the reference does not
    call it)."""
    from describealign_tpu_torch.ops import features
    real = features.feature_stack
    monkeypatch.setattr(features, "feature_stack",
                        lambda pcm, n: real(pcm, n).bfloat16().float())


def _bf16_before_preprocess(monkeypatch):
    """extract_and_match's features rounded to bfloat16 after
    feature_stack, on their way into the preprocessing."""
    from describealign_tpu_torch.alignment import matching
    real = matching.preprocess_features
    monkeypatch.setattr(matching, "preprocess_features",
                        lambda f: real(f.bfloat16().float()))


@pytest.mark.parametrize("fault", [_bf16_features, _bf16_before_preprocess],
                         ids=["feature_stack", "extract_and_match"])
def test_device_features_in_bfloat16(devfeat_root, cpu_threads, monkeypatch,
                                     fault):
    fault(monkeypatch)
    _, res = _run(devfeat_root)
    c = res["checks"]["map_gap"]
    assert not res["correct"] and c["value"] > c["limit"]
