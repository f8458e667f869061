"""The comparison fails what it must: a whole run on the CPU at a cut
size, past the harness's look for a card, with the program broken
underneath in each way a cell can break: an answer altered where it is
produced, a step that returns its state unchanged, half of a batch left
out, a batch answered short, the exchange between cards left out, the
score map computed in TF32, the features in bfloat16. A sound run
passes."""
import time

import pytest
import torch

import describealign_tpu_torch as program
from describealign_tpu_torch.alignment import api
from harness import core


def _run(root, name, seconds=1.0, seed=31):
    cell = core.Cell(root, name)
    devices = [torch.device("cpu")] * cell.chips
    _, res = core.execute(cell, seed, seconds, 0, devices, "cpu",
                          time.time())
    return res


@pytest.mark.parametrize("name", ["tiny-episode-single", "tiny-film-single",
                                  "tiny-episode-batch"])
def test_sound_run_is_correct(tiny_root, cpu_threads, name):
    res = _run(tiny_root, name)
    assert res["correct"], res["checks"]
    assert res["checks"]["missed_pct"]["value"] == 0.0


@pytest.mark.parametrize("name", ["tiny-episode-single", "tiny-film-single"])
def test_answer_altered_where_produced(tiny_root, cpu_threads, monkeypatch,
                                       name):
    real = api.similarity_and_nodes

    def late(*args, **kwargs):
        nx, ny, sim, path = real(*args, **kwargs)
        return nx, ny - 0.02, sim, path          # the picture 20 ms early

    monkeypatch.setattr(api, "similarity_and_nodes", late)
    res = _run(tiny_root, name)
    assert not res["correct"]
    assert res["checks"]["missed_pct"]["value"] > 50.0


def test_state_returned_unchanged(tiny_root, cpu_threads, monkeypatch):
    real, first = program.align_from_pcm, []

    def stale(*args, **kwargs):
        if not first:
            first.append(real(*args, **kwargs))
        return first[0]

    monkeypatch.setattr(program, "align_from_pcm", stale)
    res = _run(tiny_root, "tiny-episode-single", seconds=2.0)
    assert res["checks"]["answers"]["value"] >= 2
    assert not res["correct"]


def test_half_the_batch_left_out(tiny_root, cpu_threads, monkeypatch):
    real = program.align_batch_from_pcm

    def half(pairs, **kwargs):
        done = real(pairs[:len(pairs) // 2], **kwargs)
        return (done * 2)[:len(pairs)]

    monkeypatch.setattr(program, "align_batch_from_pcm", half)
    res = _run(tiny_root, "tiny-episode-batch")
    assert not res["correct"]


def test_exchange_between_cards_left_out(tiny_root, cpu_threads,
                                         monkeypatch):
    real = api._align_batch_sharded

    def first_card_only(pairs, true_samples, mesh, *args, **kwargs):
        # the answers of the pairs on the other cards never come back:
        # each slot holds the first card's answer of its group
        mine = real(pairs[::len(mesh)], true_samples[::len(mesh)], mesh[:1],
                    *args, **kwargs)
        return [mine[i // len(mesh)] for i in range(len(pairs))]

    monkeypatch.setattr(api, "_align_batch_sharded", first_card_only)
    assert _run(tiny_root, "tiny-episode-mesh")["correct"] is False


def test_sharded_run_is_correct(tiny_root, cpu_threads):
    res = _run(tiny_root, "tiny-episode-mesh")
    assert res["correct"], res["checks"]


def test_a_batch_answered_short(tiny_root, cpu_threads, monkeypatch):
    real = program.align_batch_from_pcm

    def short(pairs, **kwargs):
        return real(pairs[:len(pairs) // 2], **kwargs)

    monkeypatch.setattr(program, "align_batch_from_pcm", short)
    cell = core.Cell(tiny_root, "tiny-episode-batch")
    run, res = core.execute(cell, 31, 1.0, 0, [torch.device("cpu")], "cpu",
                            time.time())
    assert not res["correct"]
    assert res["failed"] == res["attempted"] > 0
    # no pair of a request answered short counts as done
    assert run.pairs_done == [] and "audio_min_per_s" not in res["metrics"]


def test_score_map_in_tf32(tiny_root, cpu_threads, monkeypatch):
    from describealign_tpu_torch.ops import coarse_map
    from references.coarse_plain import _tf32_round
    real = coarse_map.block_scores

    def tf32(desc_a, desc_v, b0, n, suppress=None):
        return real(_tf32_round(desc_a), _tf32_round(desc_v), b0, n,
                    suppress)

    monkeypatch.setattr(coarse_map, "block_scores", tf32)
    for name in ("tiny-episode-single", "tiny-film-single"):
        res = _run(tiny_root, name)
        c = res["checks"]["map_gap"]
        assert not res["correct"] and c["value"] > c["limit"], name


def test_features_in_bfloat16(tiny_root, cpu_threads, monkeypatch):
    real = api.host_features_padded

    def bf16(*args, **kwargs):
        stack, n = real(*args, **kwargs)
        return (torch.from_numpy(stack).bfloat16().float().numpy(), n)

    monkeypatch.setattr(api, "host_features_padded", bf16)
    res = _run(tiny_root, "tiny-episode-single")
    c = res["checks"]["feature_gap"]
    assert not res["correct"] and c["value"] > c["limit"]


def test_probes_keep_the_programs_counters(monkeypatch):
    from describealign_tpu_torch.ops import coarse_map
    real = coarse_map.block_scores

    def counted(*args, **kwargs):
        # as the card's path counts: on the module's own name
        coarse_map.block_scores.launches += 1
        return real(*args, **kwargs)

    counted.launches = 5
    monkeypatch.setattr(coarse_map, "block_scores", counted)
    with core.Probes():
        d = torch.zeros(640, 128)
        coarse_map.block_scores(d, torch.zeros(7, 700, 128), 0, 64)
    assert coarse_map.block_scores is counted and counted.launches == 6
