"""The generator: determinism from the seed, the adjacency's layout, the
time split, the eval negatives and the item popularity."""

import numpy as np
import pytest
import torch

from conftest import SMALL_DATA
from portbench import run
from portbench.harness import data as D

CPU = torch.device("cpu")


def _cfg():
    return dict(run.load_json("configs", "score_taobao")["data"],
                **SMALL_DATA)


def test_same_seed_same_data_other_seed_other():
    a, b = D.generate(_cfg(), 2 ** 40 + 5, CPU), D.generate(_cfg(),
                                                              2 ** 40 + 5,
                                                              CPU)
    c = D.generate(_cfg(), 6, CPU)
    for k in ("u2i", "u2i_cnt", "i2u", "i2u_cnt"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    assert not torch.equal(a.u2i, c.u2i) or not torch.equal(a.i2u, c.i2u)


@pytest.mark.parametrize("side", ["u2i", "i2u"])
def test_adjacency_layout(side):
    d = D.generate(_cfg(), 3, CPU)
    adj, cnt = getattr(d, side), getattr(d, side + "_cnt")
    nodes = d.num_users if side == "u2i" else d.num_items
    other = d.num_items if side == "u2i" else d.num_users
    k = adj.shape[-1]
    assert adj.shape[0] % 64 == 0 and adj.shape[0] >= nodes + 1
    assert adj.shape[1] == d.num_slots and k == 10
    assert not adj[0].any() and not cnt[0].any()       # the padding node
    assert not adj[nodes + 1:].any() and not cnt[nodes + 1:].any()
    assert int(cnt.max()) <= k and int(cnt.min()) >= 0
    j = torch.arange(k)
    assert not adj[j >= cnt[..., None]].any()          # zero past the count
    held = adj[j < cnt[..., None]]
    assert int(held.min()) >= 1 and int(held.max()) <= other


def test_counts_are_the_true_counts_clipped():
    d = D.generate(_cfg(), 4, CPU)
    e = d.events
    full = torch.bincount(e["user"].long() * d.num_slots + e["slot"],
                          minlength=(d.num_users + 1) * d.num_slots)
    cnt = d.u2i_cnt[:d.num_users + 1].reshape(-1)
    assert torch.equal(cnt, full.clamp_max(10).to(cnt.dtype))


def test_sampled_neighbours_are_real_events():
    d = D.generate(_cfg(), 4, CPU)
    e = d.events
    keys = set((e["user"] * 10000 + e["item"]).tolist())
    u, t, j = torch.nonzero(d.u2i > 0, as_tuple=True)
    got = (u * 10000 + d.u2i[u, t, j]).tolist()
    assert set(got) <= keys


def test_time_split():
    d = D.generate(_cfg(), 5, CPU)
    assert int(d.train["slot"].min()) >= 1 and int(d.train["slot"].max()) <= 6
    assert set(d.val["slot"].unique().tolist()) == {7}


def test_eval_negatives_miss_positive_and_seen():
    d = D.generate(_cfg(), 6, CPU)
    g = D.generator(7, CPU)
    u, i = d.val["user"][:200], d.val["item"][:200]
    neg = D.eval_negatives(d, u, i, 100, g)
    assert neg.shape == (200, 100)
    assert int(neg.min()) >= 1 and int(neg.max()) <= d.num_items
    assert not (neg == i[:, None]).any()
    seen = set((d.events["user"].long() * (d.num_items + 1)
                + d.events["item"]).tolist())
    keys = (u.long()[:, None] * (d.num_items + 1) + neg).reshape(-1)
    assert not (set(keys.tolist()) & seen)


def test_zipf_rank_frequencies():
    cfg = dict(events=400000, users=1000, items=5000, slots=9,
               item_zipf=0.9)
    _, item, _ = D.draw_events(cfg, D.generator(1, CPU), CPU)
    cnt = torch.bincount(item.long(), minlength=5000).double()
    w = torch.arange(1, 5001, dtype=torch.float64) ** -0.9
    expect = w / w.sum() * 400000
    for r in (0, 1, 9, 99):
        assert abs(cnt[r] / expect[r] - 1) < 0.05, r
    # the log-log slope over the first hundred ranks is -0.9
    r = np.arange(1, 101)
    slope = np.polyfit(np.log(r), np.log(cnt[:100].numpy()), 1)[0]
    assert abs(slope + 0.9) < 0.05


def test_popular_items_distinct_and_not_the_positive():
    d = D.generate(_cfg(), 8, CPU)
    pos = d.events["item"][:300]
    out = D.popular_items(D.popularity_cdf(d), pos, 20, D.generator(9, CPU))
    assert out.shape == (300, 20)
    assert not (out == pos[:, None]).any()
    srt = out.sort(dim=1).values
    assert not (srt[:, 1:] == srt[:, :-1]).any()
    assert int(out.min()) >= 1 and int(out.max()) <= d.num_items


@pytest.mark.cuda
def test_the_card_draws_the_same_data_twice(card):
    a, b = (D.generate(_cfg(), 2 ** 35 + 1, card) for _ in range(2))
    for k in ("u2i", "u2i_cnt", "i2u", "i2u_cnt"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    for k in ("user", "item", "slot"):
        assert torch.equal(a.train[k], b.train[k])
