"""The benchmark's inputs, made on the device from the run's seed.

One event log per run, as the port's reference-scale prep draws it
(`synth_uniform_zipf`: users uniform, items by rank weight (r+1)^-a,
slots uniform), and from it what `prep_common.build_dataset` derives,
rewritten for the device: the iterative min-count filter, ids remapped
to 1..K in raw-id order (0 is padding), one event per (user, item, slot),
the dense adjacency node-major as the port's `graph.DeviceGraph` holds it
(a uniform sample of at most `fanout` neighbours per (node, slot),
zero-padded, with its true count; node rows padded to a multiple of 64;
row 0 the padding node), the time split (train before the last two
slots, val in the one before the last, t* >= 1), and val negatives that
are neither the positive nor any item the user touched.

Everything is drawn from one `torch.Generator` on `device`, in a fixed
order, so the same seed gives the same data on the same device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

NODE_MULTIPLE = 64


@dataclasses.dataclass
class Data:
    num_users: int
    num_items: int
    num_slots: int
    u2i: torch.Tensor        # [U+1 padded, T, n] int32
    u2i_cnt: torch.Tensor    # [U+1 padded, T] int32
    i2u: torch.Tensor        # [I+1 padded, T, m] int32
    i2u_cnt: torch.Tensor    # [I+1 padded, T] int32
    events: Dict[str, torch.Tensor]   # the kept (user, item, slot) events
    train: Dict[str, torch.Tensor]    # user, item, slot of the train split
    val: Dict[str, torch.Tensor]      # user, item, slot of the val split

    def graph(self) -> Dict[str, torch.Tensor]:
        return dict(u2i=self.u2i, u2i_cnt=self.u2i_cnt, i2u=self.i2u,
                    i2u_cnt=self.i2u_cnt)


def generator(seed: int, device) -> torch.Generator:
    """The run's generator: `seed` taken modulo 2**64, as any whole number
    given as --seed may be past what 32 or 63 bits hold."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)


def draw_events(d: dict, g: torch.Generator, device):
    """`d['events']` raw (user, item, slot) draws as int32 tensors: users
    uniform over d['users'], items by rank weight (r+1)^-d['item_zipf']
    over d['items'] (inverse CDF in f64), slots uniform over d['slots']."""
    n = int(d["events"])
    user = torch.randint(0, d["users"], (n,), generator=g, device=device,
                         dtype=torch.int32)
    w = torch.arange(1, d["items"] + 1, dtype=torch.float64,
                     device=device) ** -float(d["item_zipf"])
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    item = torch.searchsorted(cdf, u).clamp_max_(d["items"] - 1).to(
        torch.int32)
    del u, cdf, w
    slot = torch.randint(0, d["slots"], (n,), generator=g, device=device,
                         dtype=torch.int32)
    return user, item, slot


def min_count_filter(user, item, slot, min_user: int, min_item: int,
                     max_rounds: int = 5):
    """Drop users, then items, with fewer events than the minimum, until
    nothing changes or `max_rounds` rounds (prep's filter_min_count)."""
    for _ in range(max_rounds):
        n0 = user.numel()
        keep = torch.bincount(user)[user] >= min_user
        user, item, slot = user[keep], item[keep], slot[keep]
        keep = torch.bincount(item)[item] >= min_item
        user, item, slot = user[keep], item[keep], slot[keep]
        if user.numel() == n0:
            break
    return user, item, slot


def remap(ids: torch.Tensor):
    """Raw ids -> 1..K in raw-id order (0 stays padding), and K."""
    present = torch.bincount(ids) > 0
    new = torch.cumsum(present, 0, dtype=torch.int32)
    return new[ids.long()], int(new[-1])


def dedup(user, item, slot, num_users: int, num_items: int):
    """One event per (slot, user, item), sorted by that key."""
    key = ((slot.long() * (num_users + 1) + user) * (num_items + 1)
           + item)
    key = torch.unique(key)
    item = (key % (num_items + 1)).to(torch.int32)
    rest = key // (num_items + 1)
    user = (rest % (num_users + 1)).to(torch.int32)
    slot = (rest // (num_users + 1)).to(torch.int32)
    return user, item, slot


def padded_rows(num_nodes: int) -> int:
    return -(-(num_nodes + 1) // NODE_MULTIPLE) * NODE_MULTIPLE


def adjacency(node, nbr, slot, num_nodes: int, num_slots: int, fanout: int,
              g: torch.Generator):
    """Dense node-major adjacency [rows, T, fanout] and counts [rows, T]:
    per (node, slot) a uniform sample, without replacement, of at most
    `fanout` of its neighbours (a random 24-bit key orders each group;
    ties keep the events' order), zero-padded, with the true count
    clipped to `fanout`."""
    rows = padded_rows(num_nodes)
    group = node.long() * num_slots + slot
    rand = torch.randint(0, 1 << 24, group.shape, generator=g,
                         device=group.device, dtype=torch.int64)
    key, order = torch.sort((group << 24) | rand, stable=True)
    del rand
    group = key >> 24
    del key
    idx = torch.arange(group.numel(), device=group.device)
    first = torch.ones_like(group, dtype=torch.bool)
    first[1:] = group[1:] != group[:-1]
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    pos = idx - start
    del idx, first, start
    keep = pos < fanout
    adj = torch.zeros(rows * num_slots * fanout, dtype=torch.int32,
                      device=group.device)
    adj[group[keep] * fanout + pos[keep]] = nbr[order[keep]]
    cnt = torch.bincount(group, minlength=rows * num_slots).clamp_max_(
        fanout).to(torch.int32)
    return (adj.view(rows, num_slots, fanout), cnt.view(rows, num_slots))


def generate(d: dict, seed: int, device) -> Data:
    """The dataset of data config `d` (events, users, items, slots,
    item_zipf, min_count, user_fanout, item_fanout, val_slots,
    test_slots) from `seed` on `device`."""
    g = generator(seed, device)
    user, item, slot = draw_events(d, g, device)
    user, item, slot = min_count_filter(user, item, slot, d["min_count"],
                                        d["min_count"])
    user, U = remap(user)
    item, I = remap(item)
    user, item, slot = dedup(user, item, slot, U, I)
    T = int(d["slots"])
    u2i, u2i_cnt = adjacency(user, item, slot, U, T, d["user_fanout"], g)
    i2u, i2u_cnt = adjacency(item, user, slot, I, T, d["item_fanout"], g)
    test_lo = T - d["test_slots"]
    val_lo = test_lo - d["val_slots"]
    splits = {}
    for name, keep in (("train", (slot >= 1) & (slot < val_lo)),
                       ("val", (slot >= max(val_lo, 1)) & (slot < test_lo))):
        splits[name] = dict(user=user[keep], item=item[keep],
                            slot=slot[keep])
    return Data(num_users=U, num_items=I, num_slots=T, u2i=u2i,
                u2i_cnt=u2i_cnt, i2u=i2u, i2u_cnt=i2u_cnt,
                events=dict(user=user, item=item, slot=slot),
                train=splits["train"], val=splits["val"])


def seen_keys(data: Data) -> torch.Tensor:
    """Sorted user * (I + 1) + item keys of every kept event."""
    e = data.events
    return torch.unique(e["user"].long() * (data.num_items + 1) + e["item"])


def eval_negatives(data: Data, users: torch.Tensor, pos: torch.Tensor,
                   num_neg: int, g: torch.Generator,
                   chunk: int = 1 << 20, max_rounds: int = 100
                   ) -> torch.Tensor:
    """[N, num_neg] int32 negatives, uniform over the items, none equal to
    the positive nor to an item the user touched (prep's
    _sample_eval_negatives: bad draws are drawn again, up to
    `max_rounds` times), in chunks of `chunk` targets."""
    seen = seen_keys(data)
    I = data.num_items
    out = []
    for lo in range(0, users.numel(), chunk):
        u = users[lo:lo + chunk].long()[:, None] * (I + 1)
        p = pos[lo:lo + chunk][:, None]
        neg = torch.randint(1, I + 1, (u.shape[0], num_neg), generator=g,
                            device=users.device, dtype=torch.int32)

        def bad_of(neg):
            keys = u + neg
            at = torch.searchsorted(seen, keys).clamp_max_(seen.numel() - 1)
            return (neg == p) | (seen[at] == keys)
        bad = bad_of(neg)
        for _ in range(max_rounds):
            if not bool(bad.any()):
                break
            redraw = torch.randint(1, I + 1, neg.shape, generator=g,
                                   device=neg.device, dtype=torch.int32)
            neg = torch.where(bad, redraw, neg)
            bad = bad & bad_of(neg)
        out.append(neg)
    return torch.cat(out)


def popularity_cdf(data: Data) -> torch.Tensor:
    """CDF over item ids 0..I of the kept events' item counts (id 0 has
    none), in f64."""
    cnt = torch.bincount(data.events["item"],
                         minlength=data.num_items + 1).double()
    cdf = torch.cumsum(cnt, 0)
    return cdf / cdf[-1]


def popular_items(cdf: torch.Tensor, pos: torch.Tensor, k: int,
                  g: torch.Generator, draws: Optional[int] = None
                  ) -> torch.Tensor:
    """[N, k] distinct items a row, drawn by popularity (`cdf`), none equal
    to the row's `pos`, in the order drawn: `draws` draws a row (default
    2k), the first k that are new kept, and a row with fewer drawn
    again."""
    n = pos.numel()
    draws = draws or 2 * k
    out = torch.zeros(n, k, dtype=torch.int32, device=pos.device)
    todo = torch.arange(n, device=pos.device)
    while todo.numel():
        u = torch.rand(todo.numel(), draws, generator=g, device=pos.device,
                       dtype=torch.float64)
        x = torch.searchsorted(cdf, u).to(torch.int32).clamp_(
            1, cdf.numel() - 1)
        srt, order = torch.sort(x, dim=1, stable=True)
        dup = torch.zeros_like(srt, dtype=torch.bool)
        dup[:, 1:] = srt[:, 1:] == srt[:, :-1]
        dup = torch.zeros_like(dup).scatter_(1, order, dup)
        ok = ~dup & (x != pos[todo][:, None])
        rank = torch.where(ok, torch.arange(draws, device=pos.device), draws)
        first = torch.sort(rank, dim=1).values[:, :k]
        full = first[:, -1] < draws
        pick = torch.gather(x, 1, first.clamp_max(draws - 1))
        out[todo[full]] = pick[full]
        todo = todo[~full]
    return out
