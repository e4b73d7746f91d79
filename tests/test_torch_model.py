"""The port's configs3 model and scoring service against the JAX package,
on `tiny_dataset` with the same non-zero weights (flax tree <-> state_dict
through score_tpu_torch.params). On the CPU the port runs its kernels'
plain versions.

Tolerances: f32 1e-4 (sums in another order, and the port's co-attention
block reassociates nothing the reference does not); bf16 rtol 2e-2 /
atol 2e-3 as tests/test_baselines.py uses for bf16 serving (both sides
round to bf16 at their own places)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu.config import configs3
from score_tpu.graph import device_graph, gather_batch, gather_candidate_batch
from score_tpu.serve import ScoringService as JaxService
from score_tpu.train import build_model
from score_tpu_torch import graph as tgraph
from score_tpu_torch.nn.model import ScoreModel
from score_tpu_torch.nn.model import build_model as tbuild_model
from score_tpu_torch.params import init_params, to_flax
from score_tpu_torch.serve import ScoringService

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-3)}


def _cfg(dtype="float32", **model_kw):
    cfg = configs3()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype=dtype, **model_kw))


def _weights(cfg, ds, seed=0):
    """init_params, then every zero-initialised leaf made non-zero and the
    tables widened so attention is far from uniform."""
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        std = 0.5 if "table" in k else 0.3 if not v.any() else None
        if std is not None:
            sd[k] = torch.from_numpy(
                rng.normal(0, std, v.shape).astype(np.float32))
    return sd


def _jax_params(sd):
    return jax.tree.map(jnp.asarray, to_flax(sd))


def _requests(ds, B, C, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.linspace(0, len(ds.train) - 1, B).astype(np.int64)
    users = ds.train.user[idx]
    slots = ds.train.slot[idx]
    cand = rng.integers(1, ds.num_items + 1, (B, C)).astype(np.int32)
    cand[0, 0] = 0   # the pad item is an ordinary row to score
    return users, slots, cand


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_candidates_matches_flax(tiny_dataset, dtype):
    ds = tiny_dataset
    cfg = _cfg(dtype)
    sd = _weights(cfg, ds)
    users, slots, cand = _requests(ds, B=6, C=5)
    jm = build_model(cfg, ds.num_users, ds.num_items)
    mb = gather_candidate_batch(device_graph(ds.graph), jnp.asarray(users),
                                jnp.asarray(cand), jnp.asarray(slots))
    want = np.asarray(jm.apply({"params": _jax_params(sd)}, mb,
                               method=jm.score_candidates))
    tm = ScoreModel(cfg.model, ds.num_users, ds.num_items)
    tm.load_state_dict(sd)
    with torch.inference_mode():
        tb = tgraph.gather_candidate_batch(
            tgraph.device_graph(ds.graph, "cpu"), torch.from_numpy(users),
            torch.from_numpy(cand), torch.from_numpy(slots))
        got = tm.score_candidates(tb).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (6, 5)
    assert np.std(want) > 1e-2      # the weights make scores differ
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_flat_forward_matches_flax(tiny_dataset):
    ds = tiny_dataset
    cfg = _cfg()
    sd = _weights(cfg, ds, seed=1)
    users, slots, cand = _requests(ds, B=7, C=1, seed=1)
    items = cand[:, 0]
    jm = build_model(cfg, ds.num_users, ds.num_items)
    mb = gather_batch(device_graph(ds.graph), jnp.asarray(users),
                      jnp.asarray(items), jnp.asarray(slots))
    want = np.asarray(jm.apply({"params": _jax_params(sd)}, mb))
    tm = ScoreModel(cfg.model, ds.num_users, ds.num_items)
    tm.load_state_dict(sd)
    g = tgraph.device_graph(ds.graph, "cpu")
    u, i, s = (torch.from_numpy(a) for a in (users, items, slots))
    u_hist, u_cnt = tgraph.gather_side(g.u2i, g.u2i_cnt, u)
    i_hist, i_cnt = tgraph.gather_side(g.i2u, g.i2u_cnt, i)
    with torch.inference_mode():
        got = tm(dict(user=u, item=i, slot=s, u_hist=u_hist, u_cnt=u_cnt,
                      i_hist=i_hist, i_cnt=i_cnt,
                      slot_valid=tgraph.slot_valid_mask(s, g.num_slots)))
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])


def test_graph_gather_matches_jax(tiny_dataset):
    """Exact integer equality of every history input and the padded
    node-major layout."""
    ds = tiny_dataset
    users, slots, cand = _requests(ds, B=5, C=3, seed=2)
    jg = device_graph(ds.graph)
    tg = tgraph.device_graph(ds.graph, "cpu")
    for name in ("u2i", "u2i_cnt", "i2u", "i2u_cnt"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    want = gather_candidate_batch(jg, jnp.asarray(users), jnp.asarray(cand),
                                  jnp.asarray(slots))
    got = tgraph.gather_candidate_batch(tg, torch.from_numpy(users),
                                        torch.from_numpy(cand),
                                        torch.from_numpy(slots))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _services(ds, dtype, **kw):
    cfg = _cfg(dtype)
    sd = _weights(cfg, ds, seed=3)
    return (ScoringService(cfg, ds, sd, device="cpu", **kw),
            JaxService(cfg, ds, _jax_params(sd), **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_service_score_and_batch_match_jax(tiny_dataset, dtype):
    ds = tiny_dataset
    port, ref = _services(ds, dtype)
    if dtype == "bfloat16":
        assert port.model.tables.user_table.dtype == torch.bfloat16
    items = np.array([1, 4, 9, 33, 0], np.int32)
    np.testing.assert_allclose(port.score(3, items), ref.score(3, items),
                               **TOL[dtype])
    rng = np.random.default_rng(4)
    users = np.array([3, 5, 8], np.int32)
    batch = rng.integers(1, ds.num_items + 1, (3, 20)).astype(np.int32)
    got = port.score_batch(users, batch)
    assert got.shape == (3, 20)
    np.testing.assert_allclose(got, ref.score_batch(users, batch),
                               **TOL[dtype])


def test_service_chunked_and_topk_match_jax(tiny_dataset):
    """candidate_chunk=16: a 40-wide request runs as blocks 16/16/8 and the
    full-catalogue topk as a chunk grid. topk is compared by its score
    multiset, so ties may order items either way."""
    ds = tiny_dataset
    port, ref = _services(ds, "float32", candidate_chunk=16)
    rng = np.random.default_rng(5)
    users = np.array([3, 5], np.int32)
    items = rng.integers(1, ds.num_items + 1, (2, 40)).astype(np.int32)
    np.testing.assert_allclose(port.score_batch(users, items),
                               ref.score_batch(users, items),
                               **TOL["float32"])
    pi, ps = port.topk(3, k=7)
    ri, rs = ref.topk(3, k=7)
    assert pi.shape == (7,) and np.all(np.diff(ps) <= 0)
    np.testing.assert_allclose(np.sort(ps), np.sort(rs), **TOL["float32"])
    # each returned item's own score agrees with the reference's
    np.testing.assert_allclose(ref.score(3, pi), ps, **TOL["float32"])
    ci, cs = port.topk(3, k=3, candidates=[5, 9, 2, 7])
    np.testing.assert_allclose(cs, ref.score(3, ci), **TOL["float32"])
    assert port.topk(3, k=0)[0].size == 0


def test_service_refuses_out_of_range_ids(tiny_dataset):
    port, _ = _services(tiny_dataset, "float32")
    with pytest.raises(ValueError):
        port.score(3, [tiny_dataset.num_items + 1])
    with pytest.raises(ValueError):
        port.score(-1, [1])


@pytest.mark.parametrize("over", [dict(dtype="float16"),
                                  dict(param_dtype="bfloat16",
                                       seq_encoder="caser"),
                                  dict(arch="mf", param_dtype="bfloat16")])
def test_model_outside_slice_raises(tiny_dataset, over):
    """What the port still does not build: f16 compute, for any arch and
    encoder (the Caser and SASRec encoders and the baseline archs
    themselves are built: tests/test_torch_baselines.py). bf16 parameters
    are built as the reference builds them: a ScoreModel flag set (here
    with the Caser encoder) gets bf16 tables and f32 dense leaves, and
    MF's tables stay f32, as the reference's baseline archs ignore
    param_dtype."""
    cfg = _cfg(**over)
    if "param_dtype" not in over:
        with pytest.raises(NotImplementedError):
            tbuild_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
        return
    model = tbuild_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    dtypes = {k: p.dtype for k, p in model.named_parameters()}
    bf16 = {k for k, v in dtypes.items() if v == torch.bfloat16}
    if cfg.model.arch == "mf":
        assert not bf16 and any("table" in k for k in dtypes)
    else:
        assert bf16 == {"tables.user_table", "tables.item_table"}
        assert any(k.startswith("gru_u.hconv_") for k in dtypes)
