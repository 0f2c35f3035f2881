"""The traffic generator: the same seed gives the same requests, and every
seed sends the same work in another order."""
import numpy as np
import pytest
import torch

from portbench.harness import traffic as T
from portbench.tests.tiny import ROOT


def mixes():
    return [T.load_mix(ROOT, "experts-poisson"), T.load_mix(ROOT, "experts-closed16")]


@pytest.mark.parametrize("mix", mixes(), ids=["poisson", "closed16"])
def test_same_seed_same_requests(mix):
    a = T.schedule(mix, 2 ** 31 + 11, 30.0, 8)
    b = T.schedule(mix, 2 ** 31 + 11, 30.0, 8)
    assert np.array_equal(a.experts, b.experts) and np.array_equal(a.due_s, b.due_s)
    pa = T.prompts(mix, 2 ** 31 + 11, 16, "cpu")
    pb = T.prompts(mix, 2 ** 31 + 11, 16, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert torch.equal(T.initial_latents(5, 4, 8, 4, "cpu"), T.initial_latents(5, 4, 8, 4, "cpu"))


@pytest.mark.parametrize("mix", mixes(), ids=["poisson", "closed16"])
def test_seeds_permute_the_same_work(mix):
    a = T.schedule(mix, 1, 30.0, 8)
    b = T.schedule(mix, 2 ** 33 + 7, 30.0, 8)
    assert not np.array_equal(a.experts, b.experts)
    assert np.array_equal(np.bincount(a.experts, minlength=8), np.bincount(b.experts, minlength=8))
    if mix["loop"] == "open":
        assert len(a) == round(mix["rate_per_s"] * 30.0)
        gaps = [np.sort(np.diff(s.due_s, prepend=0)) for s in (a, b)]
        assert np.allclose(*gaps)
        assert np.isclose(a.due_s[-1], b.due_s[-1])
    else:
        c = mix["clients"]
        for r in range(3):   # every round of `clients` requests holds the same experts
            assert np.array_equal(np.sort(a.experts[r * c:(r + 1) * c]), np.sort(b.experts[:c]))


def test_zipf_counts_and_prompt_shapes():
    mix = T.load_mix(ROOT, "experts-poisson")
    counts = T.largest_remainder(100, T.popularity(mix, 8))
    assert counts.sum() == 100 and list(counts) == sorted(counts, reverse=True)
    assert counts[0] == 37          # 100 / H_8 = 36.8
    ids, mp, mask = T.prompts(mix, 3, 8, "cpu")
    assert ids.shape == (8, 77) and mp.shape == (8, 128) and mask.shape == (8, 128)
    assert bool((ids[:, 0] == T.CLIP_BOS).all())
    assert bool(((ids == T.CLIP_EOS).sum(dim=1) == 1).all())
    assert bool((ids < 49408).all()) and bool((mp < 30527).all())


def test_arrival_laws_and_entry_points_are_found_by_name():
    from portbench.harness import named
    for loop in ("open", "closed"):
        law = named.load("arrivals", loop)
        assert callable(law.schedule) and hasattr(law, "Sender")
    assert callable(named.load("entries", "experts").queue)
    mix = dict(T.load_mix(ROOT, "experts-poisson"), loop="no-such-law")
    with pytest.raises(ValueError, match="no-such-law"):
        T.schedule(mix, 1, 30.0, 8)


def test_a_rate_cycle_sends_bursts_from_data():
    """`rate_cycle` pieces repeat over the window: 2 s at 12/s, then 8 s at
    4/s (or none); the same seed gives the same schedule."""
    mix = {k: v for k, v in T.load_mix(ROOT, "experts-poisson").items() if k != "rate_per_s"}
    mix["rate_cycle"] = [[2, 12.0], [8, 4.0]]
    a, b = T.schedule(mix, 3, 50.0, 8), T.schedule(mix, 3, 50.0, 8)
    assert np.array_equal(a.due_s, b.due_s) and np.array_equal(a.experts, b.experts)
    assert len(a) == 5 * (2 * 12 + 8 * 4) and bool((np.diff(a.due_s) >= 0).all())
    on = int((a.due_s % 10 < 2).sum())
    assert abs(on / 10 - 12.0) < 1.0 and abs((len(a) - on) / 40 - 4.0) < 0.5
    mix["rate_cycle"] = [[2, 12.0], [8, 0.0]]
    off = T.schedule(mix, 3, 50.0, 8)
    assert len(off) == 120 and bool((off.due_s % 10 < 2).all())


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_senders_send_what_is_due(loop):
    from portbench.harness import named
    mix = T.load_mix(ROOT, "experts-poisson" if loop == "open" else "experts-closed16")
    sched = T.schedule(mix, 5, 10.0, 8)
    s = named.load("arrivals", loop).Sender(sched, 10.0)
    first = s.send(0.0 if loop == "closed" else float(sched.due_s[2]))
    assert [k for k, _ in first] == list(range(len(first))) and len(first) >= 1
    assert all(d <= max(0.0, float(sched.due_s[2]) if loop == "open" else 0.0) for _, d in first)
    if loop == "closed":
        assert len(first) == mix["clients"] and s.send(1.0) == []
        s.answered(1.5)
        assert s.next_due(1.0) == 1.5 and [d for _, d in s.send(2.0)] == [1.5]
        s.answered(11.0)
        assert s.send(12.0) == [] and s.finished(12.0)
    else:
        assert not s.finished(0.0) and s.send(1e9)[-1][0] == len(sched) - 1 and s.finished(1e9)
