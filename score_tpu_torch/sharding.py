"""Row-sharded embedding tables on torch.distributed: the (data, rows)
layout, table placement and the two exchange lookups.

Counterpart of score_tpu/sharding.py. The world is a 2-D (data, rows)
grid numbered as the reference's `make_mesh` numbers its devices: rank
d * num_rows + r

  * holds row block r of every table (and of its optimizer state);
  * holds batch block d * num_rows + r, its own rank (the batch is split
    over every rank, as P((DATA, ROWS)) splits it);
  * exchanges lookups in its *rows group*, the num_rows ranks that share
    d, and sums table gradients in its *data group*, the num_data ranks
    that share r.

Two lookups gather rows that other ranks hold:

  * `psum_lookup`: the rows group's ids all-gathered, each rank gathering
    the rows it owns (others zeroed) and an all-reduce assembling them;
  * `a2a_lookup`: each rank dedups its ids and sends each unique id once
    to its owner in an all-to-all, the owner gathers and a second
    all-to-all returns the rows.

Both gather through the gather kernel and take their table gradient
through the scatter-add kernel (`kernels/gather.py`), on CUDA tensors
over NCCL and on CPU tensors, with their plain versions, over gloo.

The adjacency graph is row-sharded as the tables are (`shard_graph`):
each rank holds row block r of each side's nodes, adjacency and counts
packed as one int32 block, and a batch's histories come from their
owners through the a2a exchange at its exact capacity (`graph_rows`),
with no autograd.

    mesh, lookup_fn = bringup(cfg.sharding, init_method="file:///tmp/x",
                              world_size=4, rank=rank, device="cpu")
    state = train.init_state(cfg, nu, ni, state_dict, device="cpu",
                             mesh=mesh)
    state, metrics = train.train_step(state, graph, local_batch)
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .kernels.gather import gather_rows, scatter_add_rows

DATA_AXIS = "data"
ROWS_AXIS = "rows"


def factor_mesh(n: int) -> Tuple[int, int]:
    """Factor n ranks into (data, rows): rows gets the larger share so
    table capacity scales with the world; data >= 2 when possible so
    data-parallel gradients are exercised."""
    if n == 1:
        return (1, 1)
    data = 2
    while n % data != 0:
        data += 1
    return (data, n // data)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, rows) grid of an initialised world,
    and its two process groups (None where a group is the whole world:
    the default group)."""

    num_data: int
    num_rows: int
    rank: int
    rows_group: Optional[object]
    data_group: Optional[object]
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.num_data, ROWS_AXIS: self.num_rows}

    @property
    def size(self) -> int:
        return self.num_data * self.num_rows

    @property
    def data_index(self) -> int:
        return self.rank // self.num_rows

    @property
    def row_index(self) -> int:
        return self.rank % self.num_rows


def make_mesh(data: Optional[int] = None, rows: Optional[int] = None
              ) -> Mesh:
    """The (data, rows) grid over the initialised world (`factor_mesh` of
    its size when either is None). Every rank makes every group, in one
    order, as torch.distributed.new_group requires. The device is the
    current CUDA device under NCCL, else the CPU."""
    world = dist.get_world_size()
    if data is None or rows is None:
        data, rows = factor_mesh(world)
    if data * rows != world:
        raise ValueError(f"a ({data}, {rows}) mesh needs {data * rows} "
                         f"ranks; the world has {world}")
    rank = dist.get_rank()

    def group(ranks):
        return None if len(ranks) == world else dist.new_group(ranks)
    rows_groups = [group([d * rows + r for r in range(rows)])
                   for d in range(data)]
    data_groups = [group([d * rows + r for d in range(data)])
                   for r in range(rows)]
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(data, rows, rank, rows_groups[rank // rows],
                data_groups[rank % rows], device)


def bringup(shard_cfg=None, init_method: Optional[str] = None,
            world_size: Optional[int] = None, rank: Optional[int] = None,
            device="cuda"):
    """Join the world (unless this process already has) and lay out the
    (data, rows) grid of `shard_cfg` (a ShardingConfig; None: a world of
    one). The backend is NCCL on a CUDA device and gloo on the CPU, from
    `device`; a CUDA rank then takes the card of its LOCAL_RANK (as
    torchrun sets it), else of its rank, modulo the host's cards.
    `init_method`, `world_size` and `rank` go to init_process_group
    (None: its env:// defaults). Returns (mesh, lookup_fn), lookup_fn
    None for a world of one, as the reference's is."""
    device = torch.device(device)
    if not dist.is_initialized():
        cuda = device.type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=init_method,
                                world_size=world_size if world_size else -1,
                                rank=-1 if rank is None else rank)
        if cuda:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            torch.cuda.set_device(local % torch.cuda.device_count())
    data = shard_cfg.num_data if shard_cfg is not None else 1
    rows = shard_cfg.num_rows if shard_cfg is not None else 1
    mesh = make_mesh(data, rows)
    if data * rows <= 1:
        return mesh, None
    return mesh, make_lookup_fn(mesh, shard_cfg.lookup_mode,
                                shard_cfg.a2a_capacity)


# --- placement ------------------------------------------------------------

_TABLE_RE = re.compile(r"table")


def state_spec(name: str, tensor) -> tuple:
    """The reference's partition rule on the port's parameter names (and
    so on their optimizer state, keyed by the same names): a 2-D tensor
    with 'table' in its name is row-sharded, (ROWS_AXIS, None); anything
    else is whole on every rank, ()."""
    if _TABLE_RE.search(name) and getattr(tensor, "ndim", 0) == 2:
        return (ROWS_AXIS, None)
    return ()


def pad_rows(table: torch.Tensor, n_rows: int) -> torch.Tensor:
    """A table's rows padded with zeros up to a multiple of n_rows (the
    pad rows are never addressed by valid ids)."""
    pad = (-table.shape[0]) % n_rows
    if pad == 0:
        return table
    return torch.nn.functional.pad(table, (0, 0, 0, pad))


def _block(mesh: Mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's row block of table `name`, a copy of its own."""
    V = t.shape[0]
    if V % mesh.num_rows:
        raise ValueError(
            f"{name}: {V} rows do not split over {mesh.num_rows} row "
            f"blocks; pad the table with sharding.pad_rows")
    per = V // mesh.num_rows
    return t[mesh.row_index * per:(mesh.row_index + 1) * per].clone()


def shard_state(mesh: Mesh, state):
    """Take a TrainState's tables, and their optimizer state, down to this
    rank's row block, in place; dense parameters stay whole. The state
    keeps the mesh. The tables' 64-row padding splits over any num_rows
    that divides 64."""
    for name, p in state.model.named_parameters():
        if not state_spec(name, p):
            continue
        p.data = _block(mesh, name, p.data)
        for key in state.opt.state_keys:
            moments = getattr(state.opt, key)
            moments[name] = _block(mesh, name, moments[name])
    state.mesh = mesh
    return state


def full_tables(mesh: Mesh, params) -> dict:
    """Every parameter of a sharded TrainState, or of a state_dict of its
    blocks (`train`'s `params`), whole: the table blocks all-gathered over
    the rows group, dense parameters as they are."""
    items = (params.items() if isinstance(params, Mapping)
             else params.model.named_parameters())
    out = {}
    for name, p in items:
        t = p.detach()
        if state_spec(name, t):
            t = _all_gather(t, mesh.rows_group, mesh.num_rows).flatten(0, 1)
        out[name] = t
    return out


def shard_params(mesh: Mesh, state_dict: Mapping[str, torch.Tensor],
                 whole_rows: Mapping[str, int]) -> dict:
    """A state_dict with each table cut to this rank's row block: a table
    of `whole_rows[name]` rows is cut, one already of that over num_rows
    (a sharded checkpoint's restore) is kept; dense entries as they are."""
    out = {}
    for name, t in state_dict.items():
        if state_spec(name, t) and t.shape[0] == whole_rows[name]:
            t = _block(mesh, name, t)
        elif state_spec(name, t) and (t.shape[0] * mesh.num_rows
                                      != whole_rows[name]):
            raise ValueError(f"{name}: {t.shape[0]} rows are neither the "
                             f"table's {whole_rows[name]} nor a block of "
                             f"them over {mesh.num_rows}")
        out[name] = t
    return out


def graph_spec(name: str, tensor) -> tuple:
    """The reference's rule for the graph: adjacency [N, T, k] and counts
    [N, T] (node-major) are sharded on the node axis, anything else is
    whole."""
    ndim = getattr(tensor, "ndim", 0)
    if ndim in (2, 3):
        return (ROWS_AXIS,) + (None,) * (ndim - 1)
    return ()


@dataclasses.dataclass
class ShardedGraph:
    """This rank's row block of a graph's node axis: each side's adjacency
    and counts packed as one int32 block [N / num_rows, T * k + T] (a
    node's history, then its T counts), so one exchange serves a side."""

    mesh: Mesh
    user: torch.Tensor
    item: torch.Tensor
    num_slots: int
    fanouts: Tuple[int, int]

    @property
    def device(self) -> torch.device:
        return self.user.device


def shard_graph(mesh: Mesh, graph) -> ShardedGraph:
    """A DeviceGraph (best on the CPU: only the blocks move) cut by
    `graph_spec` to this rank's row block of each side, packed, on
    mesh.device. Its 64-row node padding splits over any num_rows that
    divides 64."""
    def side(*names):
        cut = [(_block(mesh, n, t) if graph_spec(n, t) else t)
               for n, t in ((n, getattr(graph, n)) for n in names)]
        return torch.cat([cut[0].flatten(1), cut[1]], dim=1).to(mesh.device)
    return ShardedGraph(mesh, side("u2i", "u2i_cnt"), side("i2u", "i2u_cnt"),
                        graph.num_slots, tuple(graph.fanouts))


@torch.inference_mode()
def graph_rows(mesh: Mesh, block: torch.Tensor, nodes: torch.Tensor
               ) -> torch.Tensor:
    """The packed rows of `nodes` [...] (this rank's ids) from a sharded
    graph side: the a2a exchange at its exact capacity, which never
    aliases, whatever cfg.sharding.a2a_capacity the tables use. No
    autograd; every rank of a rows group passes as many ids."""
    flat = nodes.reshape(-1)
    rows, _ = _a2a_exchange(mesh, block, flat, flat.shape[0])
    return rows.view(*nodes.shape, block.shape[1])


# --- collectives ----------------------------------------------------------

def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n, *x.shape]: x from each rank of `group`, in rank order."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...] with block j sent to rank j of `group`; block j of the
    result came from rank j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def all_gather_world(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x's rows from every rank, concatenated in rank (batch block)
    order."""
    return _all_gather(x, None, mesh.size).flatten(0, 1)


# --- psum: masked local gather + all-reduce over rows ---------------------

def _owned(mesh: Mesh, ids: torch.Tensor, per: int):
    """ids' rows in this rank's block (out-of-block ids clamped to row 0)
    and the mask of those it owns."""
    local = ids - mesh.row_index * per
    ok = (local >= 0) & (local < per)
    return torch.where(ok, local, torch.zeros_like(local)), ok


def _masked_gather(table: torch.Tensor, local: torch.Tensor,
                   ok: torch.Tensor) -> torch.Tensor:
    return gather_rows(table, local) * ok[..., None].to(table.dtype)


class _PsumLookup(torch.autograd.Function):
    """Each ids tensor's rows through the rows group's all-gather of ids,
    the owner's masked gather and an all-reduce; backward: the output
    gradients all-gathered, masked and added into the block in one
    scatter-add."""

    @staticmethod
    def forward(ctx, mesh, table, *ids):
        per, R, r = table.shape[0], mesh.num_rows, mesh.row_index
        outs, saved = [], []
        for i in ids:
            local, ok = _owned(mesh, _all_gather(i, mesh.rows_group, R), per)
            emb = _masked_gather(table, local, ok)
            dist.all_reduce(emb, group=mesh.rows_group)
            outs.append(emb[r])
            saved += [local, ok]
        ctx.mesh, ctx.per = mesh, per
        ctx.save_for_backward(*saved)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        mesh = ctx.mesh
        saved = ctx.saved_tensors
        locals_, srcs = [], []
        for j, g in enumerate(douts):
            local, ok = saved[2 * j], saved[2 * j + 1]
            g_all = _all_gather(g, mesh.rows_group, mesh.num_rows)
            locals_.append(local)
            srcs.append(g_all * ok[..., None].to(g_all.dtype))
        grad = scatter_add_rows(locals_, srcs, ctx.per)
        return (None, grad) + (None,) * len(douts)


# --- a2a: dedup, owner buckets, two all-to-alls ---------------------------

def _a2a_plan(flat: torch.Tensor, cap: int, R: int, per: int):
    """The reference's dedup and owner buckets for local ids `flat` [L]:
    the request buffer [R, cap_p] (row o: the unique ids owner o holds,
    zero-filled), the flat response position of each id [L] (its unique
    slot's place in the buckets), and the number of unique ids. Uniques
    past `cap` alias slot cap - 1."""
    L, dev = flat.shape[0], flat.device
    cap_p = -(-cap // R) * R
    # 1. dedup: sort, then each position's unique rank
    sorted_ids, order = torch.sort(flat, stable=True)
    newseg = torch.ones(L, dtype=torch.bool, device=dev)
    newseg[1:] = sorted_ids[1:] != sorted_ids[:-1]
    urank_sorted = torch.cumsum(newseg, 0) - 1
    slot_sorted = urank_sorted.clamp(max=cap - 1)
    urank = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    n_uniq = urank_sorted[-1] + 1
    slots = torch.arange(cap_p, device=dev)
    uid = torch.zeros(cap_p, dtype=flat.dtype, device=dev)
    uid[slot_sorted] = sorted_ids
    uid = torch.where(slots < n_uniq, uid, torch.zeros_like(uid))
    # 2. bucket the unique ids by owner (searchsorted offsets)
    owner = torch.clamp(uid // per, 0, R - 1)
    req_owner, o_idx = torch.sort(owner, stable=True)
    starts = torch.searchsorted(
        req_owner, torch.arange(R, dtype=req_owner.dtype, device=dev))
    req_owner = req_owner.long()
    within = slots - starts[req_owner]
    req = torch.zeros(R, cap_p, dtype=flat.dtype, device=dev)
    req[req_owner, within] = uid[o_idx]
    slot_pos = torch.empty_like(slots)
    slot_pos[o_idx] = req_owner * cap_p + within
    return req, slot_pos[urank].to(torch.int32), n_uniq


def _a2a_exchange(mesh: Mesh, table: torch.Tensor, flat: torch.Tensor,
                  cap: int):
    """The rows of local ids `flat` [L] from a row-blocked table: the
    dedup and owner buckets, the requests out, the owners' masked gather,
    the rows back, un-bucketed and un-deduped in one gather. Returns
    (rows [L, W], (pos, local, ok, n_uniq)) for the backward."""
    per, W = table.shape
    group = mesh.rows_group
    req, pos, n_uniq = _a2a_plan(flat, cap, mesh.num_rows, per)
    local, ok = _owned(mesh, _all_to_all(req, group), per)
    resp = _all_to_all(_masked_gather(table, local, ok), group)
    return gather_rows(resp.view(-1, W), pos), (pos, local, ok, n_uniq)


class _A2ALookup(torch.autograd.Function):
    """Each ids tensor's rows through its own exchange (one a lookup, as
    the reference makes them), and the overflow of each lookup summed
    over the world. Backward: each lookup's gradient pre-reduced into its
    unique slots in their bucket layout (one scatter-add), sent back by
    the reverse exchange, and every lookup's returns added into the block
    by one scatter-add."""

    @staticmethod
    def forward(ctx, mesh, capacity, table, *ids):
        outs, saved, ovf = [], [], []
        for i in ids:
            flat = i.reshape(-1)
            cap = min(capacity, flat.shape[0]) if capacity else flat.shape[0]
            rows, (pos, local, ok, n_uniq) = _a2a_exchange(mesh, table,
                                                           flat, cap)
            outs.append(rows.view(*i.shape, table.shape[1]))
            ovf.append(torch.clamp(n_uniq - cap, min=0))
            saved += [pos, local, ok]
        overflow = torch.stack(ovf)
        dist.all_reduce(overflow)           # over (DATA, ROWS): the world
        ctx.mesh, ctx.per = mesh, table.shape[0]
        ctx.save_for_backward(*saved)
        ctx.mark_non_differentiable(overflow)
        return (*outs, overflow)

    @staticmethod
    def backward(ctx, *douts):
        mesh, saved = ctx.mesh, ctx.saved_tensors
        locals_, srcs = [], []
        for j, g in enumerate(douts[:-1]):
            pos, local, ok = saved[3 * j:3 * j + 3]
            d = g.shape[-1]
            g_resp = scatter_add_rows(pos, g.reshape(-1, d), local.numel())
            g_recv = _all_to_all(g_resp.view(*local.shape, d),
                                 mesh.rows_group)
            locals_.append(local)
            srcs.append(g_recv * ok[..., None].to(g_recv.dtype))
        grad = scatter_add_rows(locals_, srcs, ctx.per)
        return (None, None, grad) + (None,) * (len(douts) - 1)


# --- lookup functions -----------------------------------------------------

class ShardedLookup:
    """A lookup into row-blocked tables over the mesh: `fn(table, ids)`
    gives the rows of ids (with 'a2a', `(rows, overflow)`), and
    `fn.grouped(table, ids_list)` all of a table's lookups, each its own
    exchange, with one scatter-add of their gradients into the block:
    (rows list, overflow [len(ids_list)] or None)."""

    def __init__(self, mesh: Mesh, mode: str, capacity: int = 0):
        if mode not in ("psum", "a2a"):
            raise ValueError(f"unknown lookup_mode {mode}")
        self.mesh, self.mode, self.capacity = mesh, mode, int(capacity)

    def grouped(self, table: torch.Tensor, ids: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        if not ids:
            return [], None
        if self.mode == "psum":
            return list(_PsumLookup.apply(self.mesh, table, *ids)), None
        *outs, overflow = _A2ALookup.apply(self.mesh, self.capacity, table,
                                           *ids)
        return outs, overflow

    def __call__(self, table: torch.Tensor, ids: torch.Tensor):
        (out,), overflow = self.grouped(table, [ids])
        return out if overflow is None else (out, overflow[0])


def psum_lookup(mesh: Mesh, table_block: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """Rows of `ids` (this rank's batch block) from a row-sharded table
    (`table_block`, this rank's rows): the rows group's ids all-gathered,
    each rank's owned rows gathered (others zeroed), all-reduced, and
    this rank's slice kept. Its gradient lands in each owner's block."""
    return ShardedLookup(mesh, "psum")(table_block, ids)


def a2a_lookup(mesh: Mesh, table_block: torch.Tensor, ids: torch.Tensor,
               capacity: int = 0, with_overflow: bool = False):
    """The north-star lookup: this rank's ids deduped (sort + unique rank),
    the unique ids bucketed by owner into [num_rows, cap_p] buffers, an
    all-to-all of the requests over the rows group, the owners' masked
    gather, an all-to-all of the rows back, un-bucketed and un-deduped.

    `capacity` caps the unique ids a rank sends (0: the exact worst case,
    its id count, which never overflows); uniques past it alias the last
    slot and read wrong rows. `with_overflow=True` returns (rows,
    overflow), the uniques past the capacity summed over the world: 0
    iff the rows are exact. Every rank of a rows group passes as many
    ids. The backward pre-reduces duplicate gradient rows before the
    reverse exchange, and the owner adds them into its block."""
    out, overflow = ShardedLookup(mesh, "a2a", capacity)(table_block, ids)
    return (out, overflow) if with_overflow else out


def make_lookup_fn(mesh: Mesh, mode: Optional[str], capacity: int = 0
                   ) -> Optional[ShardedLookup]:
    """The lookup of ShardingConfig.lookup_mode for `EmbeddingTables`:
    'psum' and 'a2a' the exchanges (a2a's calls return (rows, overflow));
    'local' with one row block is plain data parallelism, whole tables
    and the gather kernel (None); 'local' over row blocks is the
    reference's GSPMD-partitioned gather, the same rows, which the port
    runs as 'psum'."""
    if mode in (None, "local"):
        return None if mesh.num_rows == 1 else ShardedLookup(mesh, "psum")
    return ShardedLookup(mesh, mode, capacity)
