"""Weight bridge between the flax param tree and the port's state_dict (and
an optax optimizer state and the port's optimizers), and a flax-faithful
initialiser that needs no JAX.

The state_dict keys mirror the flax paths with '.' for '/'. Flax `kernel`
leaves become torch `weight` leaves:
  * 2-D Dense kernels [in, out] -> Linear weights [out, in];
  * Conv kernels [w, in, out] (Caser's hconv_*) -> conv1d's [out, in, w];
  * the attention's query, key and value kernels [in, heads, head_dim]
    -> [heads, head_dim, in], its out kernel [heads, head_dim, out] ->
    [out, heads, head_dim].
Every other leaf (tables, Wr/Wtu/Wti, the slot attention's W, the GRU's
wx/wh/b, the pooling W, biases, LayerNorm scales, MF's scalar bias) keeps
its name and layout, whichever model's tree it is.

Leaves keep their dtype, bf16 tables too, with no `ml_dtypes`: a bf16
numpy array (what np.asarray gives of a JAX bf16 array) comes in through
its bits, and goes out as the f32 array of the same values (see
`to_flax`).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .config import Config
from .nn.baselines import CASER_WIDTHS, SELFATTN_HEADS
from .nn.embed import round_up
from .nn.model import DTYPES, check_supported, scorer_width

# a 3-D kernel's axes, flax -> torch, by its module's name
_QKV_TO_TORCH = (1, 2, 0)      # [in, h, hd] -> [h, hd, in]
_OUT_TO_TORCH = (2, 0, 1)      # [h, hd, out] -> [out, h, hd]
_CONV_TO_TORCH = (2, 1, 0)     # [w, in, out] -> [out, in, w]


def _kernel_axes(path: str, ndim: int):
    """The permutation that takes the flax kernel of module `path` (dotted)
    to its torch weight."""
    if ndim == 2:
        return (1, 0)
    module = path.rstrip(".").split(".")[-1]
    if ndim == 3 and module in ("query", "key", "value"):
        return _QKV_TO_TORCH
    if ndim == 3 and module == "out":
        return _OUT_TO_TORCH
    if ndim == 3 and module.startswith("hconv_"):
        return _CONV_TO_TORCH
    raise ValueError(f"no mapping for the {ndim}-D kernel of {path!r}")


def _tensor(val) -> torch.Tensor:
    """A leaf as a tensor of its own: a tensor cloned; an array (numpy, or
    any that np.array takes) copied, a bf16 one (dtype name 'bfloat16',
    which torch.from_numpy refuses) through a uint16 view of its bits."""
    if isinstance(val, torch.Tensor):
        return val.clone()
    arr = np.array(val)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (a flax `params` tree) -> state_dict, each
    leaf in its own dtype (bf16 included)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + key + ".")
                continue
            arr = _tensor(val)
            if key == "kernel":
                out[prefix + "weight"] = arr.permute(
                    *_kernel_axes(prefix, arr.dim())).contiguous()
            else:
                out[prefix + key] = arr
    walk(tree, "")
    return out


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """state_dict -> nested dict of numpy arrays (a flax `params` tree).
    numpy has no bf16 of its own, so a bf16 leaf comes back as the f32
    array of its values, which f32 holds exactly: `jnp.asarray(a,
    jnp.bfloat16)` (or `a.astype(ml_dtypes.bfloat16)`) gives the bf16
    array bit for bit. Every other leaf keeps its dtype."""
    tree: dict = {}
    for key, val in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        arr = val.detach().cpu()
        if leaf == "weight":
            axes = _kernel_axes(".".join(path), arr.dim())
            leaf, arr = "kernel", arr.permute(*np.argsort(axes))
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        node[leaf] = arr.contiguous().numpy()
    return tree


def cast_tables(state_dict: Mapping[str, torch.Tensor],
                compute_dtype: str) -> Dict[str, torch.Tensor]:
    """With bf16 compute, the 2-D embedding tables cast to bf16 once (the
    other leaves as they are; a bf16 table, of param_dtype bf16, is left
    as it is). The model casts each gathered row to its
    compute dtype, and rounding commutes with row selection, so the scores
    are the same; the gathers move half the bytes. Serving
    (`serve.ScoringService`) and eval (`train.make_eval_step`) both cast
    here."""
    sd = dict(state_dict)
    if compute_dtype == "bfloat16":
        for k, v in sd.items():
            if "table" in k and v.dim() == 2:
                sd[k] = v.to(torch.bfloat16)
    return sd


def assign_weights(model: torch.nn.Module,
                   state_dict: Mapping[str, torch.Tensor]) -> None:
    """Make `state_dict`'s tensors the model's parameters, by name and as
    they are (shape, dtype, device): a sharded model's tables then are
    the row blocks given, where load_state_dict would want whole ones."""
    params = dict(model.named_parameters())
    if set(params) != set(state_dict):
        raise KeyError(f"weights {sorted(set(state_dict) ^ set(params))} "
                       f"are missing on one side")
    for name, t in state_dict.items():
        params[name].data = t


def opt_state_from_optax(opt_state, step: Optional[int] = None) -> dict:
    """The state of an optax optimizer of score_tpu/train.py:make_optimizer
    (adam, adamw, adagrad or sgd, at any schedule, in a chain with masked
    scales) -> {count, and its state dicts} for `train.init_state(...,
    opt_state=...)`: Adam's and AdamW's {count, mu, nu}, Adagrad's
    {count, sum_of_squares}, SGD's {count}. The parts are found by their
    fields (ScaleByAdamState's count, mu, nu; ScaleByRssState's
    sum_of_squares; ScaleByScheduleState's count), so no optax import is
    needed. sgd and adagrad at a constant lr keep no count: pass `step`,
    the flax TrainState's, for them."""
    found = {}

    def walk(node):   # optax states are (named) tuples all the way down
        for field in getattr(node, "_fields", ()):
            if field in ("mu", "nu", "sum_of_squares", "count"):
                found.setdefault(field, getattr(node, field))
        if isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
    walk(opt_state)
    if "count" in found:
        count = int(np.asarray(found.pop("count")))
        if step is not None and step != count:
            raise ValueError(f"the optax state's count {count} is not the "
                             f"train state's step {step}")
    elif step is None:
        raise ValueError("this optax state keeps no count; pass step=")
    else:
        count = int(step)
    return dict(count=count, **{k: from_flax(v) for k, v in found.items()})


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    # flax lecun_normal: truncated normal on [-2, 2] std, rescaled so the
    # variance is 1 / fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std,
                                       -2 * std, 2 * std, generator=g)


def _dense(fan_in: int, out: int, g: torch.Generator) -> dict:
    """A flax Dense's leaves: lecun-normal kernel [in, out], zero bias."""
    return {"kernel": _lecun_normal((fan_in, out), fan_in, g),
            "bias": torch.zeros(out)}


def _layer_norm(f: int) -> dict:
    return {"scale": torch.ones(f), "bias": torch.zeros(f)}


def _encoder_tree(kind: str, d: int, f: int, g: torch.Generator) -> dict:
    """The flax tree of a Caser or SASRec encoder from `d` to `f` features
    (lecun-normal kernels, fan-in over every contracted axis; zero biases;
    LayerNorm scales 1)."""
    if kind == "caser":
        tree = {f"hconv_{w}": {"kernel": _lecun_normal((w, d, f), w * d, g),
                               "bias": torch.zeros(f)}
                for w in CASER_WIDTHS}
        tree["vproj"] = _dense(d, f, g)
        tree["out"] = _dense((len(CASER_WIDTHS) + 1) * f, f, g)
        return tree
    h = SELFATTN_HEADS
    mha = {name: {"kernel": _lecun_normal((f, f), f, g).reshape(f, h, -1),
                  "bias": torch.zeros(h, f // h)}
           for name in ("query", "key", "value")}
    mha["out"] = {"kernel": _lecun_normal((f, f), f, g).reshape(h, -1, f),
                  "bias": torch.zeros(f)}
    return {"in_proj": _dense(d, f, g), "ln1": _layer_norm(f), "mha": mha,
            "ln2": _layer_norm(f), "ff1": _dense(f, 2 * f, g),
            "ff2": _dense(2 * f, f, g)}


def _baseline_tree(m, num_users: int, num_items: int, table,
                   g: torch.Generator) -> dict:
    """The flax tree of baseline arch m.arch (score_tpu/nn/baselines.py):
    EmbeddingTables (a side left out keeps its 64-row table of the pad
    id) of width d or 1, MF's zero scalar bias, DELF's Dense layers."""
    d, h = m.embed_dim, m.hidden_dim

    def tables(users=True, items=True, dim=d, shared=False):
        if shared:
            return {"table": table(1 + num_items + num_users, dim)}
        return {"user_table": table(1 + (num_users if users else 0), dim),
                "item_table": table(1 + (num_items if items else 0), dim)}
    if m.arch == "pop":
        return {"item_bias": tables(users=False, dim=1)}
    tree = {"tables": tables(shared=m.shared_table)}
    if m.arch == "delf":
        tree["hist_tables"] = tables()
        for k in ("ee", "eq", "pe", "pq"):
            tree[f"pair_{k}"] = _dense(2 * d, h, g)
        tree["head"] = _dense(4 * h, 1, g)
        return tree
    if m.arch == "svdpp":
        tree["implicit_tables"] = tables(users=False)
    tree["user_bias"] = tables(items=False, dim=1)
    tree["item_bias"] = tables(users=False, dim=1)
    tree["bias"] = torch.zeros(())
    return tree


def init_params(cfg: Config, num_users: int, num_items: int,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fresh weights of the model `cfg.model` names, drawn as flax draws
    them: normal(0.01) tables, lecun-normal GRU, Dense, Conv and
    attention kernels, zero biases, LayerNorm scales 1, and zero attention
    weights (Wr, Wtu, Wti, the slot attention's and the pooling's W). Only
    the submodules the model has get weights, as in the flax tree. Every
    leaf is f32 but ScoreModel's tables, which are drawn in f32 and
    rounded to param_dtype (the baseline archs' tables stay f32, as the
    reference's do)."""
    m = cfg.model
    check_supported(m)
    d, f = m.embed_dim, m.hidden_dim
    dual = m.sides == "dual"
    sides = ("u", "i") if dual else ("u",)
    g = generator

    def table(rows, dim=d):
        return torch.randn(round_up(rows), dim, generator=g) * 0.01
    if m.arch != "score":
        return {k: v.contiguous() for k, v in from_flax(
            _baseline_tree(m, num_users, num_items, table, g)).items()}
    sd: Dict[str, torch.Tensor] = {}
    pdt = DTYPES[m.param_dtype]
    if m.shared_table:
        sd["tables.table"] = table(1 + num_items + num_users).to(pdt)
    else:
        sd["tables.user_table"] = table(1 + num_users).to(pdt)
        sd["tables.item_table"] = table(1 + num_items).to(pdt)
    if m.slot_agg == "coattn":
        for name in ["wr"] + (["wtu", "wti"] if m.target_aware else []):
            sd[f"coattn.{name}"] = torch.zeros(d, d)
    elif m.slot_agg == "attn":
        for s in sides:
            sd[f"slot_attn_{s}.w"] = torch.zeros(d, d)
    for s in sides:
        if m.seq_encoder != "gru":
            sd.update(from_flax({f"gru_{s}": _encoder_tree(
                m.seq_encoder, d, f, g)}))
            continue
        sd[f"gru_{s}.wx"] = _lecun_normal((d, 3 * f), d, g)
        sd[f"gru_{s}.wh"] = _lecun_normal((f, 3 * f), f, g)
        sd[f"gru_{s}.b"] = torch.zeros(3 * f)
    if m.seq_pool == "attn":
        for s in sides:
            sd[f"pool_{s}.w"] = torch.zeros(f, d)
    fan_in = scorer_width(m)
    for i, w in enumerate(list(m.mlp_dims) + [1]):
        name = f"scorer.mlp_{i}" if i < len(m.mlp_dims) else "scorer.out"
        sd[f"{name}.weight"] = _lecun_normal((fan_in, w), fan_in, g).T
        sd[f"{name}.bias"] = torch.zeros(w)
        fan_in = w
    return {k: v.contiguous() for k, v in sd.items()}
