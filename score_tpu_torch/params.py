"""Weight bridge between the flax param tree and the port's state_dict (and
an optax Adam state and the port's Adam), and a flax-faithful initialiser
that needs no JAX.

The state_dict keys mirror the flax paths with '.' for '/'. Flax `Dense`
kernels ([in, out], leaf `kernel`) become torch `Linear` weights
([out, in], leaf `weight`); every other leaf (tables, Wr/Wtu/Wti, the slot
attention's W, the GRU's wx/wh/b, the pooling W, Dense biases) keeps its
name and layout, whichever rung's tree it is.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from .config import Config
from .nn.embed import round_up
from .nn.model import check_supported, scorer_width


def from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (a flax `params` tree) -> state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + key + ".")
                continue
            arr = torch.from_numpy(np.array(val))
            if key == "kernel":
                out[prefix + "weight"] = arr.T.contiguous()
            else:
                out[prefix + key] = arr
    walk(tree, "")
    return out


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """state_dict -> nested dict of numpy arrays (a flax `params` tree)."""
    tree: dict = {}
    for key, val in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        arr = val.detach().cpu()
        if leaf == "weight":
            leaf, arr = "kernel", arr.T
        node[leaf] = arr.contiguous().numpy()
    return tree


def cast_tables(state_dict: Mapping[str, torch.Tensor],
                compute_dtype: str) -> Dict[str, torch.Tensor]:
    """With bf16 compute, the 2-D embedding tables cast to bf16 once (the
    other leaves as they are). The model casts each gathered row to its
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


def opt_state_from_optax(opt_state) -> dict:
    """The Adam part of an optax state (optax.adam, alone or in a chain
    with masked scales) -> {count, mu, nu} with mu and nu as state_dicts,
    for `train.init_state(..., opt_state=...)`. Found by its fields, so no
    optax import is needed."""
    def find(node):   # optax states are (named) tuples all the way down
        if all(hasattr(node, f) for f in ("count", "mu", "nu")):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                hit = find(child)
                if hit is not None:
                    return hit
        return None
    adam = find(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    return dict(count=int(np.asarray(adam.count)), mu=from_flax(adam.mu),
                nu=from_flax(adam.nu))


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    # flax lecun_normal: truncated normal on [-2, 2] std, rescaled so the
    # variance is 1 / fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std,
                                       -2 * std, 2 * std, generator=g)


def init_params(cfg: Config, num_users: int, num_items: int,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fresh f32 weights of the rung `cfg.model` names, drawn as flax
    draws them: normal(0.01) tables, lecun-normal GRU and Dense kernels,
    zero biases and zero attention weights (Wr, Wtu, Wti, the slot
    attention's and the pooling's W). Only the submodules the rung has
    get weights, as in the flax tree."""
    m = cfg.model
    check_supported(m)
    d, f = m.embed_dim, m.hidden_dim
    dual = m.sides == "dual"
    sides = ("u", "i") if dual else ("u",)
    g = generator
    sd: Dict[str, torch.Tensor] = {}

    def table(rows):
        return torch.randn(round_up(rows), d, generator=g) * 0.01
    if m.shared_table:
        sd["tables.table"] = table(1 + num_items + num_users)
    else:
        sd["tables.user_table"] = table(1 + num_users)
        sd["tables.item_table"] = table(1 + num_items)
    if m.slot_agg == "coattn":
        for name in ["wr"] + (["wtu", "wti"] if m.target_aware else []):
            sd[f"coattn.{name}"] = torch.zeros(d, d)
    elif m.slot_agg == "attn":
        for s in sides:
            sd[f"slot_attn_{s}.w"] = torch.zeros(d, d)
    for s in sides:
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
