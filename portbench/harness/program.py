"""What the benchmark hands the program: its Config, built from a
configuration file and a traffic mix, and its views of the generated
data (the device graph the training and eval paths take, and the host
Dataset the scoring service loads)."""

from __future__ import annotations

import numpy as np
import torch

from .data import Data


def port_config(cfg: dict, batch: int, seed: int):
    """score_tpu_torch's Config of configuration `cfg` at batch `batch`;
    the train seed is the run's --seed."""
    from score_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                        TrainConfig)
    m, d, t = cfg["model"], cfg["data"], cfg["train"]
    model = ModelConfig(**{**m, "mlp_dims": tuple(m["mlp_dims"])})
    data = DataConfig(dataset=cfg["name"], num_slots=d["slots"],
                      user_fanout=d["user_fanout"],
                      item_fanout=d["item_fanout"],
                      num_train_neg=t["num_train_neg"],
                      num_eval_neg=d["num_eval_neg"],
                      train_neg_mode=t["train_neg_mode"])
    train = TrainConfig(batch_size=batch, learning_rate=t["learning_rate"],
                        optimizer=t["optimizer"], l2_emb=t["l2_emb"],
                        table_update_every=t["table_update_every"],
                        table_lr_boost=t["table_lr_boost"], seed=int(seed))
    return Config(model=model, data=data, train=train)


def device_graph(data: Data):
    """The port's DeviceGraph over the generated node-major tensors."""
    from score_tpu_torch.graph import DeviceGraph
    return DeviceGraph(u2i=data.u2i, u2i_cnt=data.u2i_cnt, i2u=data.i2u,
                       i2u_cnt=data.i2u_cnt)


def host_targets(split: dict):
    from score_tpu_torch.data.schema import Targets
    return Targets(**{k: split[k].cpu().numpy() for k in ("user", "item",
                                                          "slot")})


def host_dataset(data: Data):
    """The port's host Dataset of the generated graph, slot-major as a
    prepped dataset stores it ([T, nodes + 1, k]; no CSR, which serving
    does not read), for ScoringService, which moves it to the device
    itself."""
    from score_tpu_torch.data.schema import Dataset, GraphStore, Targets

    def slot_major(a, nodes):
        a = a[:nodes + 1]
        return np.ascontiguousarray(
            a.transpose(0, 1).cpu().numpy() if a.dim() == 2
            else a.permute(1, 0, 2).cpu().numpy())
    empty64 = np.zeros((data.num_slots, 1), np.int64)
    empty32 = np.zeros(0, np.int32)
    graph = GraphStore(
        num_users=data.num_users, num_items=data.num_items,
        num_slots=data.num_slots,
        u2i=slot_major(data.u2i, data.num_users),
        u2i_cnt=slot_major(data.u2i_cnt, data.num_users),
        i2u=slot_major(data.i2u, data.num_items),
        i2u_cnt=slot_major(data.i2u_cnt, data.num_items),
        u2i_indptr=empty64, u2i_indices=empty32,
        i2u_indptr=empty64, i2u_indices=empty32)
    none = Targets(user=empty32, item=empty32, slot=empty32)
    return Dataset(graph=graph, train=none, val=none, test=none, meta={})


def clone(state: dict) -> dict:
    return {k: v.detach().clone() for k, v in state.items()}


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
