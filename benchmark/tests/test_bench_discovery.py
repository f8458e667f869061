"""A configuration, a traffic mix and a per-layer metric are each found by
name: dropped into a copy of the benchmark as new files, with entries in
BENCHMARK.json, they run without an edit to any file already there."""
import hashlib
import json
import os
import time

import pytest
import torch

from harness import core

NEW_METRIC = '''"""Requests completed in the traced window."""


def read(run):
    return float(len(run.durations)) if run.durations else None
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_make_a_new_cell(tiny_root, cpu_threads):
    before = _digests(tiny_root)
    bdir = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(bdir, "configs", "tiny_pcm.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "new_cfg"
    cfg["layouts"] = {"solo": [{"content_s": 50.0, "kind": "plain",
                                "pieces": [["narration", 6.0],
                                           ["content", 0.0, 50.0]]}]}
    with open(os.path.join(bdir, "configs", "new_cfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bdir, "traffic", "new_mix.json"), "w") as f:
        json.dump({"mode": "single", "layout_set": "solo", "rotate": 2,
                   "lead_jitter_s": 1.0, "trace_requests": 2}, f)
    with open(os.path.join(bdir, "metrics", "new_metric.py"), "w") as f:
        f.write(NEW_METRIC)
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "new_cfg", "source": "test",
                             "file": "benchmark/configs/new_cfg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new-cell", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "align_s",
                               "workloads": ["new-cell"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(tiny_root)
    assert all(after[k] == v for k, v in before.items())

    cell = core.Cell(tiny_root, "new-cell")
    assert cell.config["name"] == "new_cfg"
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    run, res = core.execute(cell, 5, 1.0, 1, [torch.device("cpu")], "cpu",
                            time.time())
    assert res["correct"], res["checks"]
    assert res["metrics"]["new_metric"] == {"value": 2.0, "unit": "count"}


def test_unknown_workload_is_refused(tiny_root):
    with pytest.raises(core.CellError):
        core.Cell(tiny_root, "no-such-cell")


def test_the_real_cells_are_found():
    from conftest import ROOT
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = core.Cell(ROOT, w["name"])
        assert cell.config["layouts"][cell.traffic["layout_set"]]
        assert cell.end_to_end and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(cell.reader(m), "read"), m["name"]
