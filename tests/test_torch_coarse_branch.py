"""The coarse pass's branch, streamed or materialized
(matching.coarse_streamed), on the CPU with the card's memory readings
replaced: the constant alone at or below it (no query) and on the CPU; on
a card above it, the counted peak plus the headroom against the free
memory, once for each of the COARSE_PASSES passes a batch may run at
once."""
import contextlib
import os

import pytest
import torch

from describealign_tpu_torch.alignment import api
from describealign_tpu_torch.alignment import matching as tm

GIB = 2 ** 30
CARD = torch.device('cuda', 0)
FILM = (6143, 61438)            # film_pair's nb x kv, 377.4 M elements
EPISODE = (1663, 16638)         # the 22-min episode's, 27.7 M


@pytest.fixture
def card(monkeypatch):
    """An 80-GB card's readings: cudaMemGetInfo's free bytes, the caching
    allocator's reserved and allocated bytes; queries are counted."""
    state = {'free': 80 * GIB, 'reserved': 0, 'allocated': 0,
             'queries': 0}

    def mem_get_info(device=None):
        # torch reads a device without an index as the current one, 0
        assert torch.device(device) in (CARD, torch.device('cuda'))
        state['queries'] += 1
        return state['free'], 80 * GIB

    monkeypatch.setattr(torch.cuda, 'mem_get_info', mem_get_info)
    monkeypatch.setattr(torch.cuda, 'memory_reserved',
                        lambda device=None: state['reserved'])
    monkeypatch.setattr(torch.cuda, 'memory_allocated',
                        lambda device=None: state['allocated'])
    return state


def _need(passes=tm.COARSE_PASSES):
    return passes * tm.coarse_peak_bytes(*FILM) + tm.COARSE_HEADROOM_BYTES


def test_the_counted_peak():
    # the map with the suppression's int32 distances and bool mask, 9 B an
    # element: the film's 3.16 GiB; the episode's 0.23 GiB
    assert tm.coarse_peak_bytes(*FILM) == pytest.approx(
        9 * FILM[0] * FILM[1], rel=1e-3)
    assert 3.1 * GIB < tm.coarse_peak_bytes(*FILM) < 3.2 * GIB
    assert tm.coarse_peak_bytes(10, 20) == 9 * 200 + 32 * 30


@pytest.mark.parametrize('device', ['cpu', CARD, 'cuda'])
@pytest.mark.parametrize('shape', [EPISODE, (1024, 192 * 1024), (1, 1)])
def test_at_or_below_the_constant_materialized_unqueried(card, device,
                                                         shape):
    card['free'] = 0
    assert shape[0] * shape[1] <= tm.COARSE_STREAM_ELEMS
    assert tm.coarse_streamed(*shape, device) is False
    assert card['queries'] == 0


def test_the_cpu_keeps_the_constant(card, monkeypatch):
    assert tm.coarse_streamed(*FILM, 'cpu') is True
    assert tm.coarse_streamed(1024, 192 * 1024 + 1, 'cpu') is True
    # the parity tests' switch onto the streamed branch
    monkeypatch.setattr(tm, 'COARSE_STREAM_ELEMS', 0)
    assert tm.coarse_streamed(*EPISODE, 'cpu') is True
    assert tm.coarse_streamed(1, 1, torch.device('cpu')) is True
    assert card['queries'] == 0


def test_a_card_materializes_what_fits(card):
    card['free'] = _need()
    assert tm.coarse_streamed(*FILM, CARD) is False
    card['free'] = _need() - 1
    assert tm.coarse_streamed(*FILM, CARD) is True
    # what the caching allocator holds reserved but unallocated counts
    card.update(free=_need() - GIB, reserved=5 * GIB, allocated=4 * GIB)
    assert tm.coarse_streamed(*FILM, 'cuda') is False
    card.update(allocated=4 * GIB + 1)
    assert tm.coarse_streamed(*FILM, CARD) is True
    # just above the constant the same rule holds
    card.update(free=0, reserved=0, allocated=0)
    assert tm.coarse_streamed(1024, 192 * 1024 + 1, CARD) is True
    assert card['queries'] == 5


@pytest.mark.parametrize('passes', range(1, tm.COARSE_PASSES + 1))
def test_the_budget_covers_coarse_passes(card, passes):
    # room for fewer passes than COARSE_PASSES streams; for all, it fits
    card['free'] = _need(passes)
    assert tm.coarse_streamed(*FILM, CARD) is (passes < tm.COARSE_PASSES)


@pytest.mark.parametrize('cores', [1, 3, 64])
def test_the_budget_covers_a_default_batch(monkeypatch, cores):
    """COARSE_PASSES covers a batch's dispatching thread and one retry on
    each of its pool's default host_workers threads, on any host."""
    seen = []
    monkeypatch.setattr(os, 'cpu_count', lambda: cores)
    monkeypatch.setattr(api, '_align_batch_streamed',
                        lambda *args: seen.append(args[3]))
    api.align_batch_from_pcm([], device='cpu')
    assert 1 + seen[0] <= tm.COARSE_PASSES


@pytest.mark.parametrize('fits', [True, False])
def test_a_batch_budgets_its_dispatcher_and_retries(card, monkeypatch,
                                                    fits):
    """_pipelined (every batch route) at its default host_workers' most:
    the dispatching thread's pass and the pool's retries' take the same
    branch, from the one budget."""
    monkeypatch.setattr(api, '_on', lambda device: contextlib.nullcontext())
    card['free'] = _need() - (0 if fits else 1)
    seen = []

    def dispatch(v, a, sv, sa, npad, device):
        seen.append(tm.coarse_streamed(*FILM, device))
        return None, None

    def refine(parts, sv, sa, device):
        # a low-confidence retry's pass, on a pool thread
        seen.append(tm.coarse_streamed(*FILM, device))
        return 0

    out = api._pipelined([(None, None)] * 3, [(210 * 600, 210 * 660)] * 3,
                         dispatch, refine, tm.COARSE_PASSES - 1, 1, [CARD])
    assert out == [0, 0, 0]
    assert seen == [not fits] * 6
