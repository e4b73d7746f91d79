"""The weights of a configuration, made on the device from the run's seed.

Names and layouts are the port's state_dict (its flax-mirroring names,
`Linear` weights [out, in]); the shapes follow the configuration's model
block. Scales follow `params.init_params` but for two departures the
configuration file lists under `assumed`: the tables are normal with
`weights.table_std` (init_params: 0.01), and the attention matrices
(the co-attention's Wr, Wtu, Wti and the pooling's W, zero in
init_params) are normal with `weights.attn_std`, so that every softmax
the model takes has logits of order one: at init_params' scales they are
all uniform, and no check could see them. The GRU and scorer kernels are
lecun-normal (truncated at two deviations, as flax draws them), biases
zero. The tables are drawn in one call each, the other leaves in one
call together.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..reference.model import check_supported

ROW_MULTIPLE = 64
_TRUNC = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


def table_rows(n: int) -> int:
    return -(-(n + 1) // ROW_MULTIPLE) * ROW_MULTIPLE


def scorer_width(m: dict) -> int:
    d, f = m["embed_dim"], m["hidden_dim"]
    return 3 * f + 3 * d


def leaves(m: dict, num_users: int, num_items: int
           ) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every leaf of model block `m`: kind
    'table', 'attn', 'lecun' (fan_in given) or 'zero'."""
    check_supported(m)
    d, f = m["embed_dim"], m["hidden_dim"]
    sides = ("u", "i")
    out = [("tables.user_table", (table_rows(num_users), d), "table", 0),
           ("tables.item_table", (table_rows(num_items), d), "table", 0)]
    if m["slot_agg"] == "coattn":
        names = ["wr"] + (["wtu", "wti"] if m["target_aware"] else [])
        out += [(f"coattn.{k}", (d, d), "attn", 0) for k in names]
    for s in sides:
        out += [(f"gru_{s}.wx", (d, 3 * f), "lecun", d),
                (f"gru_{s}.wh", (f, 3 * f), "lecun", f),
                (f"gru_{s}.b", (3 * f,), "zero", 0)]
    if m["seq_pool"] == "attn":
        out += [(f"pool_{s}.w", (f, d), "attn", 0) for s in sides]
    fan_in = scorer_width(m)
    dims = list(m["mlp_dims"]) + [1]
    for i, w in enumerate(dims):
        name = f"scorer.mlp_{i}" if i < len(dims) - 1 else "scorer.out"
        out += [(f"{name}.weight", (w, fan_in), "lecun", fan_in),
                (f"{name}.bias", (w,), "zero", 0)]
        fan_in = w
    return out


def make(cfg: dict, num_users: int, num_items: int, g: torch.Generator,
         device) -> Dict[str, torch.Tensor]:
    """Every leaf of configuration `cfg`, f32 on `device`."""
    m, w = cfg["model"], cfg["weights"]
    spec = leaves(m, num_users, num_items)
    out: Dict[str, torch.Tensor] = {}
    for name, shape, kind, _ in spec:
        if kind == "table":
            out[name] = torch.randn(shape, generator=g, device=device
                                    ).mul_(float(w["table_std"]))
    small = [s for s in spec if s[2] != "table"]
    total = sum(math.prod(s[1]) for s in small)
    # one draw for every small leaf: standard normals truncated to
    # [-2, 2] by the inverse CDF of a uniform over that range
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    trunc = (torch.erfinv((lo + u * (1 - 2 * lo)) * 2 - 1)
             * math.sqrt(2)).float()
    normal = torch.randn(total, generator=g, device=device)
    at = 0
    for name, shape, kind, fan_in in small:
        n = math.prod(shape)
        if kind == "lecun":
            std = math.sqrt(1.0 / fan_in) / _TRUNC
            out[name] = (trunc[at:at + n] * std).view(shape).clone()
        elif kind == "attn":
            out[name] = (normal[at:at + n] * float(w["attn_std"])
                         ).view(shape).clone()
        else:
            out[name] = torch.zeros(shape, device=device)
        at += n
    return out
