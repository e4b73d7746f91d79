"""The port's grouped table gradient on the CPU: `gather_rows_grouped` (all
of a step's lookups into one table, one scatter-add in the backward) and
the segments of `scatter_add_rows`, where the wrappers run their plain
versions (tests/test_torch_cuda.py holds the kernel to these on the card).

Against separate `gather_rows` calls, `index_add_` of the concatenated
segments and `jax.grad` of the JAX package's `jnp.take` lookups: exact on
integer-valued upstream gradients (sums of integers are exact in any
order). The models' table gradients, grouped against separate lookups,
agree to 1e-6 relative: the same rows summed in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_tpu_torch import graph as tgraph
from score_tpu_torch.config import configs0, configs1, configs3
from score_tpu_torch.kernels import gather as tgather
from score_tpu_torch.nn import embed as tembed
from score_tpu_torch.nn.model import ScoreModel
from score_tpu_torch.params import init_params

torch.set_num_threads(2)

V, W = 60, 8
# groups of ids shapes: one lookup; a table's two (candidates, histories);
# three with an empty one; four
GROUPS = [[(7,)], [(5, 1), (5, 3, 4)], [(6,), (6, 2, 3, 4), (0,)],
          [(4, 1), (4, 3), (2,), (9, 2)]]


def _group(seed, shapes):
    """A table, ids of each shape (a third of them the pad row 0) and
    integer-valued output gradients."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(V, W)).astype(np.float32))
    ids, douts = [], []
    for s in shapes:
        i = rng.integers(0, V, s).astype(np.int32)
        i[rng.random(s) < 0.33] = 0
        ids.append(torch.from_numpy(i))
        douts.append(torch.from_numpy(
            rng.integers(-8, 9, s + (W,)).astype(np.float32)))
    return table, ids, douts


def _grad(table, lookups, ids, douts):
    t = table.clone().requires_grad_(True)
    outs = lookups(t, ids)
    (g,) = torch.autograd.grad(
        sum((o * d).sum() for o, d in zip(outs, douts)), [t])
    return [o.detach() for o in outs], g


@pytest.mark.parametrize("shapes", GROUPS, ids=[str(len(g)) for g in GROUPS])
def test_grouped_gather_matches_separate_lookups(shapes):
    table, ids, douts = _group(len(shapes), shapes)
    outs, grad = _grad(table, tgather.gather_rows_grouped, ids, douts)
    want_outs, want = _grad(
        table, lambda t, ids: [tgather.gather_rows(t, i) for i in ids], ids,
        douts)
    for o, w in zip(outs, want_outs):
        assert torch.equal(o, w)
    assert torch.equal(grad, want)


@pytest.mark.parametrize("shapes", GROUPS, ids=[str(len(g)) for g in GROUPS])
def test_grouped_gather_grad_matches_jax_take(shapes):
    table, ids, douts = _group(10 + len(shapes), shapes)
    want = jax.grad(lambda tb: sum(
        jnp.sum(jnp.take(tb, jnp.asarray(i.numpy()), axis=0) * d.numpy())
        for i, d in zip(ids, douts)))(jnp.asarray(table.numpy()))
    _, grad = _grad(table, tgather.gather_rows_grouped, ids, douts)
    np.testing.assert_array_equal(grad.numpy(), np.asarray(want))


def test_grouped_gather_skips_a_segment_without_gradient():
    """A lookup whose output does not reach the loss adds nothing; with no
    gradient at all, the lookups are plain gathers."""
    table, ids, douts = _group(3, [(5, 1), (5, 3, 4)])
    t = table.clone().requires_grad_(True)
    outs = tgather.gather_rows_grouped(t, ids)
    (g,) = torch.autograd.grad((outs[1] * douts[1]).sum(), [t])
    assert torch.equal(g, tgather.scatter_add_rows_plain(ids[1], douts[1], V))
    with torch.no_grad():
        plain = tgather.gather_rows_grouped(t, ids)
    assert not any(o.requires_grad for o in plain)
    assert all(torch.equal(o, w.detach()) for o, w in zip(plain, outs))


@pytest.mark.parametrize("integer", [True, False])
def test_scatter_add_segments_match_one_index_add(integer):
    """Segments added in order equal index_add_ over their concatenation,
    through the plain version and through scatter_add_rows on the CPU."""
    rng = np.random.default_rng(int(integer))
    lengths = [300, 0, 41, 7]
    ids = [torch.from_numpy(rng.integers(0, V, n).astype(np.int32))
           for n in lengths]
    make = ((lambda n: rng.integers(-8, 9, (n, W))) if integer
            else (lambda n: rng.normal(size=(n, W))))
    src = [torch.from_numpy(make(n).astype(np.float32)) for n in lengths]
    want = torch.zeros(V, W).index_add_(0, torch.cat(ids), torch.cat(src))
    for got in (tgather.scatter_add_rows_plain(ids, src, V),
                tgather.scatter_add_rows(ids, src, V)):
        if integer:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    one = tgather.scatter_add_rows(ids[0], src[0], V)
    assert torch.equal(one, tgather.scatter_add_rows_plain([ids[0]],
                                                           [src[0]], V))
    with pytest.raises(ValueError):
        tgather.scatter_add_rows(ids, src[:2], V)


RUNGS = {"configs0": configs0, "configs1": configs1, "configs3": configs3}


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_model_table_gradients_grouped_equal_separate(tiny_dataset, rung,
                                                      monkeypatch):
    """configs0 (three lookups into the shared table), configs1 and
    configs3 (two into each table): every parameter's gradient through the
    grouped lookups against the same model with one lookup a call."""
    cfg = RUNGS[rung]()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, embed_dim=8, hidden_dim=8, mlp_dims=(16, 8)))
    ds = tiny_dataset
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    for k, v in sd.items():
        if "table" in k or not v.any():
            sd[k] = torch.from_numpy(
                rng.normal(0, 0.5, v.shape).astype(np.float32))
    model = ScoreModel(cfg.model, ds.num_users, ds.num_items)
    model.load_state_dict(sd)
    graph = tgraph.device_graph(ds.graph, "cpu")
    B, C = 32, 3
    users = torch.from_numpy(ds.train.user[:B].astype(np.int32))
    slots = torch.from_numpy(ds.train.slot[:B].astype(np.int32))
    cand = torch.from_numpy(
        rng.integers(1, ds.num_items + 1, (B, C)).astype(np.int32))
    mb = tgraph.gather_candidate_batch(graph, users, cand, slots,
                                       item_side=model.dual)
    weights = torch.from_numpy(rng.normal(size=(B, C)).astype(np.float32))
    params = dict(model.named_parameters())

    def grads():
        loss = (model.score_candidates(mb) * weights).sum()
        return dict(zip(params, torch.autograd.grad(loss, list(
            params.values()))))

    grouped = grads()
    monkeypatch.setattr(tembed, "gather_rows_grouped",
                        lambda t, ids: [tgather.gather_rows(t, i)
                                        for i in ids])
    separate = grads()
    assert any("table" in k for k in params)
    for k in params:
        scale = max(separate[k].abs().max().item(), 1e-6)
        torch.testing.assert_close(grouped[k], separate[k], rtol=1e-6,
                                   atol=1e-6 * scale, msg=k)
