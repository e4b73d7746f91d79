"""bf16 parameters (ModelConfig.param_dtype='bfloat16') in the port
against the JAX package, on `tiny_dataset` at tiny widths: ScoreModel's
tables and their optimizer state in bf16, every other leaf f32.

  * the optimizers (adam, adamw, adagrad, sgd at a constant rate, a
    10-step warmup and warmup + cosine, table boost 2.0) on a bf16 table
    and an f32 dense leaf: the bf16 params and state equal optax's bit for
    bit after 5 steps of the same gradients;
  * the table gradient of a grouped lookup with heavy repeats (f32 and
    bf16 compute): within 1 bf16 ulp of the f64 sum rounded to bf16,
    bit-equal to JAX's where an id occurs once, and elsewhere within the
    bound of JAX's own rounding (see _JAX_SCATTER_ULPS); the L2 term's
    gradient bit-equal to JAX's;
  * every leaf's dtype that of the flax init, for six presets, and a bf16
    flax tree and optax state through the port and back bit for bit;
  * serving (4 x 256) against the JAX service on the same bf16 weights at
    tests/test_torch_model.py's tolerances;
  * three stride-2 configs3 steps against make_train_step;
  * train() with checkpoints resuming bit-exact, and from_checkpoint
    serving what train() returned.

The deliberate divergence: the port sums a bf16 table's gradient in f32
and rounds once (csrc/scatter_add.cu's bf16 form, and its plain
version); XLA's scatter-add on a bf16 table rounds at every add, in id
order. Tables that differ in their last bits after one Adam step reach
every later step's dense gradients, so the train-step test holds each
step taken from the reference's state (see its docstring)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from score_tpu import config as jconfig
from score_tpu.data.pipeline import TargetIterator
from score_tpu.graph import device_graph
from score_tpu.serve import ScoringService as JaxService
from score_tpu.train import (_table_l2, build_model, init_state,
                             item_importance_weights, make_optimizer,
                             make_train_step)
from score_tpu_torch import config as tconfig
from score_tpu_torch import graph as tgraph
from score_tpu_torch import optim as toptim
from score_tpu_torch import train as ttrain
from score_tpu_torch.checkpoint import CheckpointManager
from score_tpu_torch.kernels.gather import gather_rows_grouped
from score_tpu_torch.nn.embed import EmbeddingTables
from score_tpu_torch.params import (from_flax, init_params,
                                    opt_state_from_optax, to_flax)
from score_tpu_torch.serve import ScoringService

torch.set_num_threads(2)

BF16 = torch.bfloat16
B = 64
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)       # tests/test_torch_train.py's
TOL = dict(rtol=1e-4, atol=1e-6)
SERVE_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),      # test_torch_model
             "bfloat16": dict(rtol=2e-2, atol=2e-3)}


def _bits(x) -> np.ndarray:
    """The bits of a bf16 or f32 array or tensor, as integers."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == BF16
                else x.view(torch.int32)).numpy()
    x = jnp.asarray(x)
    return np.asarray(jax.lax.bitcast_convert_type(
        x, jnp.int16 if x.dtype == jnp.bfloat16 else jnp.int32))


def _ulps(got: torch.Tensor, want: torch.Tensor,
          floor: float = 2.0 ** -126) -> torch.Tensor:
    """|got - want| in bf16 ulps of the larger magnitude, or of `floor`
    where both are below it."""
    got, want = got.double(), want.double()
    m = torch.maximum(got.abs(), want.abs()).clamp_min(floor)
    return (got - want).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)


def _to_jax(sd):
    """A state_dict as a flax tree of JAX arrays, the table leaves in
    bf16 when the state_dict's are (`to_flax` gives them as f32)."""
    tree = to_flax(sd)
    bf16 = {k.split(".")[-1] for k, v in sd.items() if v.dtype == BF16}

    def leaf(path, v):
        name = jax.tree_util.keystr(path[-1:]).strip("[]'")
        return jnp.asarray(v, jnp.bfloat16 if name in bf16 else None)
    return jax.tree_util.tree_map_with_path(leaf, tree)


# --- the optimizers --------------------------------------------------------

OPTIMIZERS = {"adam": {}, "adamw": dict(weight_decay=0.5),
              "adagrad": dict(learning_rate=1e-2),
              "sgd": dict(learning_rate=0.5)}
SCHEDULES = {"constant": {}, "warmup": dict(warmup_steps=10),
             "cosine": dict(lr_schedule="cosine", warmup_steps=2,
                            decay_steps=6)}
OPT_STEPS = 5


def _opt_cfg(module, opt, sched):
    cfg = module.configs3()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, optimizer=opt, table_lr_boost=2.0, **OPTIMIZERS[opt],
        **SCHEDULES[sched]))


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_optimizer_matches_optax_bit_for_bit(opt, sched):
    """A bf16 [64, 16] table and an f32 [16, 4] dense leaf, the same
    gradients for 5 steps (a few table rows zero), against optax
    (make_optimizer on the same tree, its update and apply jitted): every
    bf16 leaf (the table and its state) bit-equal, the port doing optax's
    arithmetic in bf16, its constants rounded to bf16 and each op
    rounded. The f32 leaf's path is the f32-parameter one, unchanged,
    held at tests/test_torch_optim.py's tolerance: XLA fuses f32 ops that
    torch runs one by one (2 of the 64 entries were 2 f32 ulps apart)."""
    rng = np.random.default_rng(0)
    table = rng.normal(0, 0.01, (64, 16)).astype(np.float32)
    dense = rng.normal(0, 0.3, (16, 4)).astype(np.float32)
    tree = {"tables": {"item_table": jnp.asarray(table, jnp.bfloat16)},
            "dense": {"w": jnp.asarray(dense)}}
    grads = []
    for _ in range(OPT_STEPS):
        g_t = rng.normal(0, 1e-3, table.shape).astype(np.float32)
        g_t[rng.random(64) < 0.2] = 0.0
        grads.append({"tables": {"item_table": jnp.asarray(
            g_t, jnp.bfloat16)}, "dense": {"w": jnp.asarray(
                rng.normal(0, 1e-2, dense.shape).astype(np.float32))}})
    tx = make_optimizer(_opt_cfg(jconfig, opt, sched))

    @jax.jit
    def update(g, s, p):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s
    params, state = tree, tx.init(tree)
    port_params = from_flax(tree)
    port = toptim.make_optimizer(_opt_cfg(tconfig, opt, sched), port_params)
    for g in grads:
        params, state = update(g, state, params)
        tg = from_flax(g)
        port.step(list(port_params), [tg[k] for k in port_params])
    jopt = opt_state_from_optax(state, step=OPT_STEPS)
    assert port.count == jopt.pop("count") == OPT_STEPS
    pairs = [(f"param {k}", port_params[k], v)
             for k, v in from_flax(params).items()]
    pairs += [(f"{key} {k}", getattr(port, key)[k], v)
              for key, leaves in jopt.items() for k, v in leaves.items()]
    assert {what for what, _, v in pairs if v.dtype == BF16} >= {
        "param tables.item_table"}
    for what, got, want in pairs:
        assert got.dtype == want.dtype, what
        if want.dtype == BF16:
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=what)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       err_msg=what, **TOL)


# --- the table gradient ----------------------------------------------------

GRAD_V, GRAD_D, GRAD_T, GRAD_N = 96, 8, 9, 10
# ids of the [B, 1] targets and the [B, T, n] histories, in-batch style:
# the histories draw from a few hot rows (hundreds of repeats each), a
# few rows are looked up once, and id 0 is the masked pad slot
HOT_ROWS = 24
# the port's table gradient from JAX's, in bf16 ulps of each entry's sum of
# magnitudes (the scale of the partial sums XLA rounds at every add): 1.56
# measured here (JAX's own distance from the exact sum 1.57, the hot rows
# ~200 adds each), the bound 2.5 times that
_JAX_SCATTER_ULPS = 4.0


def _grad_ids(rng):
    tgt = rng.integers(1, GRAD_V, (B, 1)).astype(np.int32)
    hist = rng.integers(1, HOT_ROWS, (B, GRAD_T, GRAD_N)).astype(np.int32)
    hist[rng.random(hist.shape) < 0.3] = 0
    return [tgt, hist]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_table_gradient_of_grouped_lookup(compute):
    """The bf16 table's gradient of sum(rows.astype(compute) * w) over a
    grouped lookup ([64, 1] targets and [64, 9, 10] histories, hot rows
    taken ~200 times each), against the exact sum of the rows' bf16
    cotangents (w rounded to bf16, as the cast's transpose gives them)
    in f64 rounded to bf16: every entry within 1 bf16 ulp (an f32 sum,
    rounded once). Against jax.grad of the same function: bit-equal on
    rows looked up once; on the others JAX's scatter-add rounds at every
    add, in id order, and the distance is printed and held to
    _JAX_SCATTER_ULPS."""
    rng = np.random.default_rng(1)
    table = rng.normal(0, 0.01, (GRAD_V, GRAD_D)).astype(np.float32)
    ids = _grad_ids(rng)
    cdt = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (BF16, jnp.bfloat16)}[compute]
    ws = [rng.normal(0, 1.0, (*i.shape, GRAD_D)).astype(np.float32)
          for i in ids]

    t = torch.from_numpy(table).to(BF16).requires_grad_(True)
    rows = gather_rows_grouped(t, [torch.from_numpy(i) for i in ids])
    loss = sum((r.to(cdt[0]) * torch.from_numpy(w).to(cdt[0])).sum()
               for r, w in zip(rows, ws))
    (got,) = torch.autograd.grad(loss, [t])
    assert got.dtype == BF16

    def jloss(tb):
        return sum((jnp.take(tb, jnp.asarray(i), axis=0).astype(cdt[1])
                    * jnp.asarray(w, cdt[1])).sum() for i, w in zip(ids, ws))
    jgot = jax.jit(jax.grad(jloss))(jnp.asarray(table, jnp.bfloat16))
    want_jax = from_flax({"g": jgot})["g"]

    exact, scale = np.zeros((GRAD_V, GRAD_D)), np.zeros((GRAD_V, GRAD_D))
    for i, w in zip(ids, ws):
        cot = torch.from_numpy(w).to(BF16).double().numpy()
        np.add.at(exact, i.reshape(-1), cot.reshape(-1, GRAD_D))
        np.add.at(scale, i.reshape(-1), np.abs(cot).reshape(-1, GRAD_D))
    exact = torch.from_numpy(exact)
    # the bf16 ulp of each entry's sum of magnitudes: the scale of the
    # partial sums JAX rounds
    ulp_scale = torch.exp2(torch.floor(torch.log2(torch.from_numpy(
        scale).clamp_min(2.0 ** -126))) - 7)
    assert _ulps(got, exact.to(BF16)).max() <= 1.0
    counts = np.bincount(np.concatenate([i.reshape(-1) for i in ids]),
                         minlength=GRAD_V)
    assert counts.max() > 150 and (counts == 1).sum() >= 5
    once = torch.from_numpy(counts == 1)
    np.testing.assert_array_equal(_bits(got[once]), _bits(want_jax[once]))
    dist = (got.double() - want_jax.double()).abs() / ulp_scale
    jax_err = (want_jax.double() - exact).abs() / ulp_scale
    print(f"{compute}: port vs JAX's table gradient: "
          f"{int((got != want_jax).sum())} of {got.numel()} entries differ, "
          f"by at most {_ulps(got, want_jax).max().item():.1f} ulps of the "
          f"entry, {dist.max().item():.2f} ulps of its sum of magnitudes "
          f"(JAX from the exact sum {jax_err.max().item():.2f}; the port "
          f"{_ulps(got, exact).max().item():.3f} ulps of the entry)")
    assert dist.max() <= _JAX_SCATTER_ULPS


def test_l2_gradient_bit_equal_to_jax():
    """`train.table_l2(model, l2_emb)` on bf16 tables (a bf16 sum of
    squares a table, times l2_emb rounded to bf16) added to an f32 loss:
    its gradient bit-equal to jax.grad of the reference's l2 *
    _table_l2(params); the value within bf16 rounding of it."""
    rng = np.random.default_rng(2)
    tables = EmbeddingTables(40, 70, 8, dtype=BF16)
    sd = {k: torch.from_numpy(rng.normal(0, 0.3, p.shape).astype(
        np.float32)).to(BF16) for k, p in tables.named_parameters()}
    tables.load_state_dict(sd)
    l2 = 1e-5
    reg = ttrain.table_l2(tables, l2)
    assert reg.dtype == BF16
    loss = torch.tensor(0.25) + reg
    assert loss.dtype == torch.float32
    got = torch.autograd.grad(loss, [tables.user_table, tables.item_table])

    def jloss(params):
        reg = l2 * _table_l2(params)
        return jnp.float32(0.25) + reg, reg
    jtree = _to_jax(sd)
    (_, jreg), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jtree)
    assert jreg.dtype == jnp.bfloat16
    wg = from_flax(jgrad)
    for k, g in zip(("user_table", "item_table"), got):
        assert g.dtype == wg[k].dtype == BF16
        np.testing.assert_array_equal(_bits(g), _bits(wg[k]), err_msg=k)
    np.testing.assert_allclose(reg.float().item(), float(jreg),
                               rtol=2 ** -7)


# --- init and conversion ---------------------------------------------------

def _with_bf16(module, preset, compute="float32", **model_kw):
    cfg = module.PRESETS[preset]()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, param_dtype="bfloat16", compute_dtype=compute,
        **model_kw))


def _zeros_like_tree(tree):
    return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), tree)


@pytest.mark.parametrize("preset", ["configs0", "configs3", "configs4",
                                    "baseline_mf", "baseline_delf",
                                    "baseline_sasrec"])
def test_state_dtypes_are_the_flax_inits(tiny_dataset, preset):
    """With param_dtype bf16: every parameter and optimizer-state leaf of
    the port's init_state has the dtype of the reference's init_state
    leaf of the same name (its shapes traced by jax.eval_shape): bf16
    tables and moments for ScoreModel's presets (configs4's held
    unsharded), f32 for MF's and DELF's tables, f32 for every dense
    leaf."""
    ds = tiny_dataset
    jcfg = _with_bf16(jconfig, preset)
    cfg = _with_bf16(tconfig, preset)
    if preset == "configs4":
        jcfg = jcfg.replace(sharding=jconfig.ShardingConfig())
        cfg = cfg.replace(sharding=tconfig.ShardingConfig())
    jm = build_model(jcfg, ds.num_users, ds.num_items)
    shapes = jax.eval_shape(lambda: init_state(
        jcfg, jm, device_graph(ds.graph), jax.random.PRNGKey(0)))
    want = from_flax(_zeros_like_tree(shapes.params))
    jopt = opt_state_from_optax(_zeros_like_tree(shapes.opt_state))
    st = ttrain.init_state(cfg, ds.num_users, ds.num_items, init_params(
        cfg, ds.num_users, ds.num_items, torch.Generator().manual_seed(0)),
        device="cpu")
    got = {k: p.dtype for k, p in st.model.named_parameters()}
    assert got == {k: v.dtype for k, v in want.items()}
    for key in ("mu", "nu"):
        assert {k: v.dtype for k, v in getattr(st.opt, key).items()} == {
            k: v.dtype for k, v in jopt[key].items()}
    tables = {k for k in got if "table" in k}
    bf16 = {k for k, v in got.items() if v == BF16}
    assert bf16 == (set() if preset in ("baseline_mf", "baseline_delf")
                    else tables) and tables


@pytest.fixture(scope="module")
def steps_setup(tiny_dataset):
    """The reference's configs3 (in-batch IW, stride 2 at 2x, tiny widths,
    f32 compute) with bf16 parameters: its model, init_state and step."""
    ds = tiny_dataset

    def cfg(module):
        c = _with_bf16(module, "configs3", embed_dim=8, hidden_dim=8,
                       mlp_dims=(16, 8))
        return c.replace(
            data=dataclasses.replace(c.data, train_neg_mode="inbatch_iw"),
            train=dataclasses.replace(c.train, batch_size=B,
                                      table_update_every=2,
                                      table_lr_boost=2.0))
    jcfg, tcfg = cfg(jconfig), cfg(tconfig)
    jg = device_graph(ds.graph)
    jm = build_model(jcfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    jstate = jax.jit(lambda r: init_state(jcfg, jm, jg, r))(rng)
    neg_iw = item_importance_weights(ds.train, ds.num_items)
    return dict(ds=ds, jcfg=jcfg, cfg=tcfg, jg=jg, jm=jm, rng=rng,
                jstate=jstate, neg_iw=neg_iw,
                jstep=make_train_step(jm, jcfg, neg_iw=jnp.asarray(neg_iw)),
                tg=tgraph.device_graph(ds.graph, "cpu"))


def _find(node, field):
    """The first (named) tuple in an optax state with `field`."""
    if hasattr(node, field):
        return node
    for child in node if isinstance(node, tuple) else ():
        found = _find(child, field)
        if found is not None:
            return found
    return None


def test_bf16_tree_and_optax_state_round_trip(steps_setup):
    """The reference's bf16-parameter flax tree and Adam state (numpy's
    bf16 arrays, which torch.from_numpy refuses) into the port and back
    through to_flax (bf16 leaves as f32 arrays of the same values), each
    leaf bit-equal to the original as a JAX array of its dtype."""
    js = steps_setup["jstate"]
    tree = jax.tree.map(np.asarray, js.params)
    sd = from_flax(tree)
    assert sd["tables.item_table"].dtype == BF16
    back = to_flax(sd)
    opt = opt_state_from_optax(jax.device_get(js.opt_state))
    adam = _find(js.opt_state, "mu")
    pairs = [(tree, back)] + [(getattr(adam, key), to_flax(opt[key]))
                              for key in ("mu", "nu")]
    n_bf16 = 0
    for orig, got in pairs:
        leaves = jax.tree_util.tree_leaves_with_path(orig)
        flat = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(leaves) == len(flat)
        for path, v in leaves:
            g = jnp.asarray(flat[path], v.dtype)
            n_bf16 += v.dtype == jnp.bfloat16
            np.testing.assert_array_equal(_bits(g), _bits(v),
                                          err_msg=str(path))
    assert n_bf16 == 6          # the two tables, their mu and nu


# --- serving ---------------------------------------------------------------

def _serving_weights(cfg, ds):
    """init_params, the zero leaves made non-zero and the tables widened
    (std 0.5, rounded to bf16), as tests/test_torch_model.py's."""
    sd = init_params(cfg, ds.num_users, ds.num_items,
                     torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    for k, v in sd.items():
        std = 0.5 if "table" in k else 0.3 if not v.any() else None
        if std is not None:
            sd[k] = torch.from_numpy(rng.normal(0, std, v.shape).astype(
                np.float32)).to(v.dtype)
    return sd


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", ["configs3", "baseline_sasrec"])
def test_service_matches_jax_on_bf16_weights(tiny_dataset, preset, compute):
    """ScoringService on bf16-parameter weights (bf16 tables, held as they
    are: neither compute casts them) against the JAX service on the same
    weights: 4 users x 256 items, at tests/test_torch_model.py's
    tolerances."""
    ds = tiny_dataset
    cfg = _with_bf16(tconfig, preset, compute)
    sd = _serving_weights(cfg, ds)
    port = ScoringService(cfg, ds, sd, device="cpu")
    assert {k: p.dtype for k, p in port.model.named_parameters()
            if "table" in k} == {k: BF16 for k in sd if "table" in k}
    ref = JaxService(_with_bf16(jconfig, preset, compute), ds, _to_jax(sd))
    rng = np.random.default_rng(4)
    users = ds.test.user[:4]
    items = rng.integers(1, ds.num_items + 1, (4, 256)).astype(np.int32)
    got = port.score_batch(users, items)
    want = np.asarray(ref.score_batch(users, items))
    assert got.shape == (4, 256) and np.std(want) > 1e-2
    np.testing.assert_allclose(got, want, **SERVE_TOL[compute])


# --- the train step --------------------------------------------------------

# each step from the reference's state: the share of a table's entries
# more than 1 bf16 ulp from the reference's, ulps of the larger of the
# entry and an Adam step (lr x boost: an entry that lands near 0 after
# the step keeps the step's absolute rounding; 0.16% measured), and
# every entry's distance in Adam steps (2 lr x boost: a differently
# rounded gradient near 0 can flip its update's sign; 0.76 of it measured)
TABLE_ULP_SHARE, TABLE_ADAM_STEPS = 0.02, 1.0
# the moments: each entry within this many bf16 ulps of its leaf's
# largest magnitude (0.5 measured)
MOMENT_LEAF_ULPS = 1.0


def _port_state(s, jstate):
    return ttrain.init_state(
        s["cfg"], s["ds"].num_users, s["ds"].num_items,
        from_flax(jax.tree.map(np.asarray, jstate.params)), device="cpu",
        opt_state=opt_state_from_optax(jax.device_get(jstate.opt_state)))


def _leaf_ulp(x: torch.Tensor) -> float:
    return 2.0 ** (np.floor(np.log2(x.float().abs().max().item())) - 7)


def test_three_stride2_steps_match_make_train_step(steps_setup):
    """configs3 (in-batch IW, stride 2 at 2x, Adam, L2, f32 compute) with
    bf16 parameters: full, dense and full steps against make_train_step,
    the reference's shifts fed in.

    Chained from the reference's init, the losses agree within bf16's
    rtol (2^-8) and every leaf within the Adam steps it took (tables 2 lr
    x boost a table step, dense leaves 2 lr a step), the largest distance
    printed. Held tighter, each step is taken from the reference's state
    after the step before (the port's state built from it): the dense
    leaves within tests/test_torch_train.py's f32 tolerance, the loss
    within its rtol 1e-5, the table leaves within TABLE_ULP_SHARE and
    TABLE_ADAM_STEPS and the moments within MOMENT_LEAF_ULPS. The tables
    differ because the reference's XLA scatter-add rounds a bf16 table's
    gradient at every add and the port's sums in f32 and rounds once: the
    tables part in their last bits on the first table step, and Adam
    moves an entry by a full step whatever its gradient's size. Chained,
    those tables reach the later steps' dense gradients, which is why
    the tight check starts each step from the reference's state."""
    s = steps_setup
    lr, boost = s["cfg"].train.learning_rate, s["cfg"].train.table_lr_boost
    it = TargetIterator(s["ds"].train, B, seed=3)
    batches = [next(it) for _ in range(3)]
    neg_iw = torch.from_numpy(s["neg_iw"])
    jstates = [s["jstate"]]
    chained = _port_state(s, s["jstate"])
    for step, batch in enumerate(batches):
        shifts = [int(x) for x in np.asarray(jax.random.randint(
            jax.random.fold_in(s["rng"], step), (1,), 1, B,
            dtype=jnp.int32))]
        start = jax.tree.map(jnp.copy, jstates[-1])   # the step donates
        js, jm = s["jstep"](start, s["jg"], {k: jnp.asarray(v)
                                             for k, v in batch.items()},
                            s["rng"])
        jstates.append(js)
        chained, cm = ttrain.train_step(chained, s["tg"], batch, shifts,
                                        neg_iw)
        np.testing.assert_allclose(cm["loss"].item(), float(jm["loss"]),
                                   rtol=2 ** -8)
        one = _port_state(s, jstates[-2])
        one, m = ttrain.train_step(one, s["tg"], batch, shifts, neg_iw)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   **LOSS_TOL)
        want = from_flax(jax.tree.map(np.asarray, js.params))
        jopt = opt_state_from_optax(jax.device_get(js.opt_state))
        for k, p in one.model.named_parameters():
            got = p.detach()
            assert got.dtype == want[k].dtype, k
            if "table" not in k:
                np.testing.assert_allclose(got.numpy(), want[k].numpy(),
                                           err_msg=k, **TOL)
                continue
            assert got.dtype == BF16
            d = (got.double() - want[k].double()).abs()
            share = (_ulps(got, want[k], lr * boost) > 1
                     ).double().mean().item()
            assert share <= TABLE_ULP_SHARE, (step, k, share)
            assert d.max() <= TABLE_ADAM_STEPS * 2 * lr * boost, (step, k)
            for key in ("mu", "nu"):
                mine, ref = getattr(one.opt, key)[k], jopt[key][k]
                assert mine.dtype == ref.dtype == BF16
                far = (mine.double() - ref.double()).abs().max().item()
                assert far <= MOMENT_LEAF_ULPS * _leaf_ulp(ref), (step, key)
            print(f"step {step} {k}: {share:.4f} of entries past 1 ulp, "
                  f"at most {d.max().item():.3e} from the reference's")
    assert chained.step == chained.opt.count == 3
    want = from_flax(jax.tree.map(np.asarray, jstates[-1].params))
    table_steps = 2       # steps 0 and 2
    for k, p in chained.model.named_parameters():
        d = (p.detach().double() - want[k].double()).abs().max().item()
        most = (2 * lr * boost * table_steps if "table" in k
                else 2 * lr * 3)
        print(f"chained, after 3 steps: {k} at most {d:.3e} from the "
              f"reference's (bound {most:.1e})")
        assert d <= most, k


# --- train(), checkpoints and serving from them ----------------------------

def test_train_resumes_bit_exact_and_serves_best(tiny_dataset, tmp_path):
    """train() of configs3 with bf16 parameters (tiny widths, batch 512,
    22 steps an epoch, val every 11): a 2-epoch run, and the same run as
    1 epoch then a second train() resuming from its `latest` checkpoint,
    bit-equal in every val row, the test metrics and the best weights
    (bf16 tables); the checkpoint holds bf16 tables and moments; and
    from_checkpoint('best') scores bit-equal to a service on the weights
    train() returned."""
    ds = tiny_dataset
    cfg = _with_bf16(tconfig, "configs3", embed_dim=8, hidden_dim=8,
                     mlp_dims=(16, 8))
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(
            cfg.train, batch_size=512, table_update_every=2,
            table_lr_boost=2.0, num_epochs=2, eval_every_steps=11,
            early_stop_patience=100, log_every_steps=10 ** 9,
            eval_max_targets=256))
    straight = ttrain.train(cfg, ds, verbose=False, device="cpu")
    ck = str(tmp_path / "ck")

    def run(epochs):
        return ttrain.train(cfg.replace(train=dataclasses.replace(
            cfg.train, num_epochs=epochs, checkpoint_dir=ck)), ds,
            verbose=False, device="cpu")
    first, second = run(1), run(2)
    assert second["timing"]["start_step"] == first["steps_run"] == 22
    strip = lambda r: {k: v for k, v in r.items() if k != "elapsed_s"}
    assert [strip(r) for r in first["history"] + second["history"]] == \
        [strip(r) for r in straight["history"]]
    assert second["test"] == straight["test"]
    best = second["params"]
    assert best["tables.item_table"].dtype == BF16
    for k, v in straight["params"].items():
        assert torch.equal(best[k], v), k
    saved = CheckpointManager(ck).restore("latest", torch.device("cpu"))
    for k in ("tables.user_table", "tables.item_table"):
        assert saved["params"][k].dtype == BF16
        for key in ("mu", "nu"):
            assert saved["opt_state"][key][k].dtype == BF16
    svc = ScoringService.from_checkpoint(cfg, ds, ck, device="cpu")
    users = ds.test.user[:4]
    items = np.random.default_rng(0).integers(1, ds.num_items + 1, (4, 100))
    np.testing.assert_array_equal(
        svc.score_batch(users, items),
        ScoringService(cfg, ds, best, device="cpu").score_batch(users,
                                                                items))
