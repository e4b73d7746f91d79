"""Schema-identical synthetic raw logs (SURVEY.md §7.0: no network).

The port's own copy of score_tpu/data/synth.py, since score_tpu_torch
imports nothing of the JAX package. Keep the two equal:
tests/test_torch_nojax.py compares what they produce.

With no network access the CCMR / Taobao-UserBehavior / Tmall raw files
cannot be downloaded. This module generates raw logs with the same on-disk
schema, driven by a latent-factor interaction model so that learned metrics are
meaningfully above chance: user u interacts with item i with probability
rising in <p_u, q_i> plus an item-popularity bias, and preferences drift
slowly over time (so temporal slots carry signal for the sequence encoders).

Raw schemas emitted (one CSV per dataset, matching the public files):
    ccmr:    user_id,item_id,rating,timestamp
    taobao:  user_id,item_id,category_id,behavior_type,timestamp
    tmall:   user_id,item_id,cat_id,seller_id,brand_id,time_stamp,action_type
"""

from __future__ import annotations

import os

import numpy as np


def synth_events(num_users: int, num_items: int, num_events: int,
                 num_slots: int = 10, latent_dim: int = 8,
                 seed: int = 0, mode: str = "latent",
                 num_communities: int = 16, burst_rho: float = 0.7,
                 burst_scale: float = 2.0, sig_frac: float = 0.5,
                 junk_frac: float = 0.3, junk_item_frac: float = 0.02,
                 stable_frac: float = 0.5, persist: float = 0.75,
                 drift_active: float = 1.0):
    """Event generator -> (user, item, ts) int arrays.

    mode='latent': static latent factors + popularity + slow drift. A strong
    (u, i)-embedding model can learn everything — history adds little.

    mode='collab': adds community-trend dynamics that make *dual-side
    neighbor histories* genuinely predictive: users belong to communities,
    items have per-slot per-community affinity bursts following an AR(1)
    process (rho correlates adjacent slots). Which communities an item is
    currently hot in is visible only through its recent interaction
    neighbors, so models that encode the item's user-history (configs1+)
    and relate it to the user side (configs3) hold signal a static
    factorization cannot (basis for the ladder's quality ordering).

    mode='crossattr': signal that is genuinely *cross-side relational*
    (VERDICT.md r1 #1): an event fires when the user's CURRENT active
    attribute equals the item's CURRENT audience attribute, where "current"
    drifts over time for half of each population:
      * A = num_communities attributes. Half the users are stable (one
        static attr, learnable into eu); half drift (Markov chain over
        slots). Half the items serve one static audience; half rotate
        (Markov). Signal events match attrs at event time; junk events hit
        a small hot item pool (zipf); the rest are uniform noise.
      * For a drifting user / rotating item, the static embedding can only
        learn the drift AVERAGE — the current attr is readable ONLY from
        recent one-hop neighbors (the stable ones among them), and the
        match evidence is PAIRWISE: a user-side neighbor and an item-side
        neighbor sharing an attr. Mechanism per rung:
          - configs0 (user-only) cannot see the item's audience at all.
          - configs1 (dual mean) pools both sides -> match in expectation,
            diluted by junk/noise neighbors and the off-attr mixture.
          - configs2 (target-aware per-side attention) can denoise with the
            TARGET embeddings as queries — works only on the stable half of
            each side (a rotator's ei / drifter's eu is uninformative), so
            the hard drifting×rotating quadrant stays diluted.
          - configs3 (cross co-attention) queries each side with the OTHER
            side's current neighbors via the bilinear Eu Wr Ei^T — scoring
            exactly the cross-side neighbor-pair matches the signal is made
            of (paper §3.3), no target embedding in the loop.

    ts spans [0, num_slots * 86400) so equal-width bucketing at `num_slots`
    recovers the generative slots.
    """
    rng = np.random.default_rng(seed)
    if mode == "crossattr":
        return _crossattr_events(
            rng, num_users, num_items, num_events, num_slots,
            num_communities, sig_frac, junk_frac, junk_item_frac,
            stable_frac=stable_frac, persist=persist,
            drift_active=drift_active)
    pu = rng.normal(size=(num_users, latent_dim)).astype(np.float32)
    qi = rng.normal(size=(num_items, latent_dim)).astype(np.float32)
    # Popularity: zipf-ish item bias.
    pop = -np.log(np.arange(1, num_items + 1) / num_items).astype(np.float32)
    pop = pop[rng.permutation(num_items)]
    # Slow preference drift: per-slot rotation of user factors.
    drift = rng.normal(scale=0.15, size=(num_slots, latent_dim)).astype(
        np.float32).cumsum(axis=0)

    if mode == "collab":
        com_u = rng.integers(0, num_communities, size=num_users)
        burst = np.zeros((num_slots, num_communities, num_items), np.float32)
        burst[0] = burst_scale * rng.normal(
            size=(num_communities, num_items))
        for s in range(1, num_slots):
            burst[s] = (burst_rho * burst[s - 1]
                        + burst_scale * np.sqrt(1 - burst_rho ** 2)
                        * rng.normal(size=(num_communities, num_items)))

    users = rng.integers(0, num_users, size=num_events)
    slots = rng.integers(0, num_slots, size=num_events)
    items = np.empty(num_events, dtype=np.int64)
    cand = 32  # score a candidate set per event, take softmax sample
    for s in range(num_slots):
        m = slots == s
        k = int(m.sum())
        if k == 0:
            continue
        cands = rng.integers(0, num_items, size=(k, cand))
        pu_s = pu[users[m]] + drift[s][None, :]
        logits = np.einsum("kd,kcd->kc", pu_s, qi[cands]) + pop[cands]
        if mode == "collab":
            logits = logits + burst[s][com_u[users[m]][:, None], cands]
        logits -= logits.max(axis=1, keepdims=True)
        prob = np.exp(logits)
        prob /= prob.sum(axis=1, keepdims=True)
        pick = (prob.cumsum(axis=1) > rng.random((k, 1))).argmax(axis=1)
        items[m] = cands[np.arange(k), pick]

    ts = slots * 86400 + rng.integers(0, 86400, size=num_events)
    order = np.argsort(ts, kind="stable")
    return (users[order].astype(np.int64), items[order].astype(np.int64),
            ts[order].astype(np.int64))


def _markov_chain(rng, n: int, num_slots: int, A: int,
                  persist: float) -> np.ndarray:
    """[num_slots, n] attr chains: keep value w.p. persist, else resample."""
    chain = np.empty((num_slots, n), dtype=np.int64)
    chain[0] = rng.integers(0, A, size=n)
    for s in range(1, num_slots):
        keep = rng.random(n) < persist
        chain[s] = np.where(keep, chain[s - 1], rng.integers(0, A, size=n))
    return chain


def _crossattr_events(rng, num_users: int, num_items: int, num_events: int,
                      num_slots: int, A: int, sig_frac: float,
                      junk_frac: float, junk_item_frac: float,
                      stable_frac: float = 0.5, persist: float = 0.75,
                      drift_active: float = 1.0):
    """See synth_events(mode='crossattr'). Vectorized per slot.

    drift_active > 1 makes DRIFTING users proportionally more active, so
    both train and (time-split) eval targets skew toward the users whose
    static embedding cannot carry their current attr — the quadrant where
    per-side target-aware attention (configs2) has no usable query and
    cross co-attention's neighbor-pair evidence is the only signal."""
    n_junk = min(max(int(junk_item_frac * num_items), 1), num_items - 1)
    perm = rng.permutation(num_items)
    junk_items = perm[:n_junk]
    attributed = perm[n_junk:]
    A = max(min(A, attributed.size), 1)

    # Item audience attr per slot: stable half broadcast, rotating half a
    # Markov chain. b[s, j] = audience attr of attributed item j at slot s.
    n_stable_i = int(stable_frac * attributed.size)
    b = np.empty((num_slots, attributed.size), dtype=np.int64)
    b[:, :n_stable_i] = np.arange(n_stable_i) % A          # static
    b[:, n_stable_i:] = _markov_chain(rng, attributed.size - n_stable_i,
                                      num_slots, A, persist)
    # User active attr per slot.
    n_stable_u = int(stable_frac * num_users)
    a = np.empty((num_slots, num_users), dtype=np.int64)
    a[:, :n_stable_u] = rng.integers(0, A, size=n_stable_u)
    a[:, n_stable_u:] = _markov_chain(rng, num_users - n_stable_u,
                                      num_slots, A, persist)

    if drift_active != 1.0:
        w_u = np.ones(num_users)
        w_u[n_stable_u:] = drift_active
        users = rng.choice(num_users, size=num_events, p=w_u / w_u.sum())
    else:
        users = rng.integers(0, num_users, size=num_events)
    slots = rng.integers(0, num_slots, size=num_events)
    items = np.empty(num_events, dtype=np.int64)
    etype = rng.random(num_events)
    sig = etype < sig_frac
    junk = (etype >= sig_frac) & (etype < sig_frac + junk_frac)
    rnd = ~sig & ~junk
    # Junk: zipf-weighted hot pool.
    w = 1.0 / np.arange(1, n_junk + 1)
    items[junk] = junk_items[rng.choice(n_junk, size=int(junk.sum()),
                                        p=w / w.sum())]
    items[rnd] = rng.integers(0, num_items, size=int(rnd.sum()))
    # Signal: per slot, a uniform item among those CURRENTLY serving the
    # user's CURRENT attr (CSR buckets over the slot's audience attrs).
    for s in range(num_slots):
        m = sig & (slots == s)
        k_ev = a[s, users[m]]                              # wanted attr
        order = np.argsort(b[s], kind="stable")
        bucket_cnt = np.bincount(b[s], minlength=A)
        bucket_off = np.concatenate([[0], np.cumsum(bucket_cnt)])
        # empty bucket (possible at small A margins): fall back to uniform
        empty = bucket_cnt[k_ev] == 0
        pick = bucket_off[k_ev] + np.minimum(
            (rng.random(k_ev.size) * bucket_cnt[k_ev]).astype(np.int64),
            np.maximum(bucket_cnt[k_ev] - 1, 0))
        chosen = attributed[order[pick]]
        if empty.any():
            chosen[empty] = rng.integers(0, num_items, size=int(empty.sum()))
        items[m] = chosen

    ts = slots * 86400 + rng.integers(0, 86400, size=num_events)
    order = np.argsort(ts, kind="stable")
    return (users[order].astype(np.int64), items[order].astype(np.int64),
            ts[order].astype(np.int64))


def write_raw(dataset: str, path: str, num_users: int = 2000,
              num_items: int = 4000, num_events: int = 200_000,
              num_slots: int = 10, seed: int = 0,
              mode: str = "collab", **gen_kw) -> str:
    """Write a schema-identical raw CSV for `dataset` and return its path.
    Extra kwargs pass through to synth_events (generator knobs)."""
    user, item, ts = synth_events(num_users, num_items, num_events,
                                  num_slots=num_slots, seed=seed, mode=mode,
                                  **gen_kw)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rng = np.random.default_rng(seed + 1)
    n = user.size
    if dataset == "ccmr":
        rating = rng.integers(1, 6, size=n)
        cols = np.stack([user, item, rating, ts], axis=1)
        header = "user_id,item_id,rating,timestamp"
    elif dataset == "taobao":
        cat = item % 97
        behav = np.zeros(n, dtype=np.int64)  # 0 == 'pv' click
        cols = np.stack([user, item, cat, behav, ts], axis=1)
        header = "user_id,item_id,category_id,behavior_type,timestamp"
    elif dataset == "tmall":
        cat = item % 71
        seller = item % 199
        brand = item % 131
        action = np.zeros(n, dtype=np.int64)
        cols = np.stack([user, item, cat, seller, brand, ts, action], axis=1)
        header = ("user_id,item_id,cat_id,seller_id,brand_id,"
                  "time_stamp,action_type")
    else:
        raise ValueError(f"unknown dataset {dataset}")
    np.savetxt(path, cols, fmt="%d", delimiter=",", header=header, comments="")
    return path
