"""The device mesh and its sharding rules, on torch.distributed.

Counterpart of `parallel/mesh.py` in the JAX package, where one
`jax.sharding.Mesh` with three axes replaces the reference's distribution
stack (Lightning DDP, `nn.DataParallel`, DeepSpeed ZeRO-3 with CPU offload).
Here the same three axes are a `DeviceMesh` over an explicit process group:

  data  - replicas of the parameters; gradients are averaged over it
  fsdp  - parameter and optimizer-state sharding (ZeRO-3): FSDP2's
          `fully_shard` on the ("data", "fsdp") sub-mesh, which is HSDP,
          replicated over data and sharded over fsdp
  model - Megatron tensor parallelism of the transformer trunks (DiT,
          Latte and Swin attention qkv and proj, the MLPs' fc1 and fc2):
          DTensor column- and row-parallel linears, one all-reduce after
          each row-parallel product

A batch is split over the ranks of data x fsdp (every FSDP rank takes its
own slice, as DeepSpeed's ZeRO-3 ranks do), and ranks that differ only in
their model coordinate take the same slice. The JAX mesh puts the batch on
"data" alone and lets the fsdp replicas compute the same slice; both give
the same global step.

The backend is the caller's: "nccl" on cards, "gloo" on the CPU. Nothing
switches it.
"""

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "fsdp", "model")


# -------------------------------------------------------------- process group

def init_process(backend: str, rank: int, world_size: int,
                 init_method: str) -> torch.device:
    """Join the process group (`init_method` a tcp:// or file:// address)
    and return this rank's device: cuda:rank % device_count for "nccl",
    the CPU for "gloo"."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            device_id=device if backend == "nccl" else None)
    return device


def init_from_env(backend: str) -> torch.device:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device:
    cuda:LOCAL_RANK for "nccl", the CPU for "gloo"."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world,
                            device_id=device if backend == "nccl" else None)
    return device


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_torchrun(device=None) -> torch.device:
    """An entry point's process group under torchrun: "gloo" when the
    caller asks for the CPU (device "cpu"), else "nccl" on
    cuda:LOCAL_RANK. Raises outside torchrun."""
    if not launched_by_torchrun():
        raise RuntimeError("multi-GPU runs start under torchrun (RANK and "
                           "WORLD_SIZE are not set)")
    cpu = device is not None and torch.device(device).type == "cpu"
    return init_from_env("gloo" if cpu else "nccl")


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------- mesh

def make_mesh(data: int = -1, fsdp: int = 1, model: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ("data", "fsdp", "model") mesh over every rank of the process
    group; data=-1 takes the ranks fsdp and model leave. The mesh's
    tensors live on "cuda" under NCCL and on the CPU under gloo unless
    `device_type` says otherwise (gloo ranks on a card)."""
    n = dist.get_world_size()
    fsdp = max(1, fsdp)
    model = max(1, model)
    if data <= 0:
        data = n // (fsdp * model)
    if data * fsdp * model != n:
        raise ValueError(f"mesh {data}x{fsdp}x{model} does not cover the "
                         f"{n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (data, fsdp, model),
                            mesh_dim_names=AXES)
    # the ranks that share a batch slice differ only in their model
    # coordinate: one group of data x fsdp ranks per model coordinate
    ranks = mesh.mesh.reshape(data * fsdp, model)
    mesh.batch_group = None
    for m in range(model):
        group = dist.new_group([int(r) for r in ranks[:, m]])
        if dist.get_rank() in ranks[:, m]:
            mesh.batch_group = group
    return mesh


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """Extent of a mesh axis; 1 without a mesh."""
    if mesh is None:
        return 1
    return int(mesh.shape[AXES.index(name)])


def batch_shard(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """(index, count) of this rank's slice of a global batch: its position
    among the data x fsdp ranks."""
    if mesh is None:
        return 0, 1
    fsdp = axis_size(mesh, "fsdp")
    return (mesh.get_local_rank("data") * fsdp + mesh.get_local_rank("fsdp"),
            axis_size(mesh, "data") * fsdp)


class RankBatch(dict):
    """A batch that is already this rank's slice (what the sharded loaders
    yield): `shard_batch` leaves it as it is."""


def _take(x, index: int, count: int):
    m = x.shape[0] // count
    return x[index * m:(index + 1) * m]


def shard_batch(batch: Dict[str, Any], mesh: Optional[DeviceMesh]) -> dict:
    """This rank's contiguous slice of every array of a global batch (numpy
    arrays or tensors, the batch on the leading axis)."""
    index, count = batch_shard(mesh)
    if count == 1 or isinstance(batch, RankBatch):
        return batch
    b = next(iter(batch.values())).shape[0]
    if b % count:
        raise ValueError(f"batch {b} does not split over {count} ranks")
    return RankBatch({k: _take(v, index, count) for k, v in batch.items()})


def shard_batch_or_replicate(batch: Dict[str, Any],
                             mesh: Optional[DeviceMesh]) -> Tuple[dict, bool]:
    """(batch, sharded): `shard_batch` where the batch splits evenly over
    the ranks, else the whole batch on every rank. Validation runs
    drop_last=False, so an epoch's last batch can be ragged; replicating it
    keeps every metric the single-device one (padding would bias the
    mean)."""
    _, count = batch_shard(mesh)
    if isinstance(batch, RankBatch):
        return batch, True
    b = next(iter(batch.values())).shape[0]
    if count == 1 or b % count:
        return batch, False
    return shard_batch(batch, mesh), True


def pad_shard(batch: Dict[str, Any], mesh: Optional[DeviceMesh]
              ) -> Tuple[dict, int]:
    """(this rank's slice, the batch's size) of a serving batch padded to
    a multiple of the batch ranks by repeating its last example."""
    b = next(iter(batch.values())).shape[0]
    _, count = batch_shard(mesh)
    pad = (-b) % count
    if pad:
        batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                 for k, v in batch.items()}
    return shard_batch(batch, mesh), b


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group's ranks; its backward sums the gradients the
    same way (each rank's input reaches every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """Every rank's x (equal shapes) concatenated on dim 0 in rank order;
    the backward hands each rank the sum over the ranks of its part's
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.n = x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the ranks of `group`, with autograd; complex values go
    as pairs of reals."""
    if x.is_complex():
        return torch.view_as_complex(_AllReduceSum.apply(
            torch.view_as_real(x), group))
    return _AllReduceSum.apply(x, group)


def all_gather_batch(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's slice of a batch concatenated in rank order, with
    autograd; complex values go as pairs of reals."""
    if x.is_complex():
        return torch.view_as_complex(_AllGather.apply(
            torch.view_as_real(x), group))
    return _AllGather.apply(x, group)


def gather_batch(x: torch.Tensor, mesh: Optional[DeviceMesh],
                 size: int) -> torch.Tensor:
    """Every rank's slice of a batch, concatenated in rank order and cut to
    `size` (the inverse of `pad_shard`)."""
    if batch_shard(mesh)[1] == 1:
        return x[:size]
    return all_gather_batch(x, mesh.batch_group)[:size]


def global_mean(values: Dict[str, torch.Tensor], mesh: Optional[DeviceMesh],
                sharded: bool = True) -> Dict[str, torch.Tensor]:
    """Means of per-rank 0-d metrics over the batch ranks, in one
    all-reduce (gloo has no AVG). Replicated batches give every rank the
    same values, which are returned as they are."""
    if mesh is None or not sharded or batch_shard(mesh)[1] == 1:
        return values
    keys = sorted(values)
    flat = torch.stack([values[k].detach().float().reshape(())
                        for k in keys])
    dist.all_reduce(flat, group=mesh.batch_group)
    flat /= batch_shard(mesh)[1]
    return {k: flat[i] for i, k in enumerate(keys)}


# ---------------------------------------------------------------------- fsdp

def _fsdp_spec(shape, fsdp_size: int) -> Optional[int]:
    """The axis to shard over fsdp: the largest one divisible by the fsdp
    extent; None (replicate) for small parameters and indivisible shapes."""
    if fsdp_size == 1 or int(np.prod(shape)) < 2 * 1024 * fsdp_size:
        return None
    cands = [(dim, ax) for ax, dim in enumerate(shape) if dim % fsdp_size == 0]
    if not cands:
        return None
    return max(cands)[1]


def apply_fsdp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """`fully_shard` on the ("data", "fsdp") sub-mesh: HSDP, parameters
    replicated over data and sharded over fsdp, gradients averaged over
    both. The shard axis follows `_fsdp_spec`; FSDP2 shards every
    parameter, so the ones that rule would replicate (small or
    indivisible) take FSDP2's default, dim 0, padded."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor, Shard

    fsdp = axis_size(mesh, "fsdp")

    def placement(param):
        if isinstance(param, DTensor):    # tensor-parallel: FSDP2's default
            return None
        ax = _fsdp_spec(param.shape, fsdp)
        return None if ax is None else Shard(ax)

    fully_shard(model, mesh=mesh["data", "fsdp"], shard_placement_fn=placement)
    return model


# ------------------------------------------------------------ tensor parallel

# Megatron rules over the port's module names: the column-parallel layer of
# each pair splits its output features, the row-parallel one its input
# features (JAX `_TP_RULES`: qkv and Mlp Dense_0 on the output axis, proj
# and Mlp Dense_1 on the input axis)
_TP_PAIRS = (("qkv", "proj"), ("fc1", "fc2"))


def _heads_first(rows: torch.Tensor, heads: int, tp: int) -> torch.Tensor:
    """qkv's output features laid out (3, heads, head_dim) reordered to
    (tp, 3, heads/tp, head_dim), so that a contiguous split of them gives
    each model rank q, k and v of its own heads (Megatron's layout)."""
    shape = rows.shape
    r = rows.reshape(3, tp, heads // tp, -1, *shape[1:])
    return r.transpose(0, 1).reshape(shape)


def _heads_back(rows: torch.Tensor, heads: int, tp: int) -> torch.Tensor:
    """The inverse of `_heads_first`."""
    shape = rows.shape
    r = rows.reshape(tp, 3, heads // tp, -1, *shape[1:])
    return r.transpose(0, 1).reshape(shape)


def _tp_modules(model: nn.Module, tp: int):
    """(name, module, kind) of every attention ("attn": qkv, proj and
    num_heads) and MLP ("mlp": fc1 and fc2) the plan splits at extent tp;
    a module whose heads or hidden features do not divide by tp is left
    whole (the fall-back of JAX `_tp_spec`: replicated, or sharded by the
    fsdp rule)."""
    for name, m in model.named_modules():
        if isinstance(getattr(m, "qkv", None), nn.Linear) and isinstance(
                getattr(m, "proj", None), nn.Linear) and hasattr(
                m, "num_heads"):
            if m.num_heads % tp == 0:
                yield name, m, "attn"
        elif type(m).__name__ == "Mlp" and isinstance(
                getattr(m, "fc1", None), nn.Linear):
            if m.fc1.out_features % tp == 0:
                yield name, m, "mlp"


def apply_tp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Megatron tensor parallelism over the "model" axis: qkv and fc1
    column-parallel, proj and fc2 row-parallel; the column-parallel outputs
    and the row-parallel inputs are plain local tensors, so the attention
    kernels see this rank's heads as ordinary [W, H/tp, N, D] tensors. qkv's
    rows are reordered first (`_heads_first`), and each attention keeps
    H/tp heads; a Swin relative-position bias table stays whole on every
    rank, and each rank reads its heads' columns (`head_columns`, which
    sums the table's gradient over the model group). Raises when the
    model axis is larger than 1 and nothing matched."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.parallel import (
        ColwiseParallel, RowwiseParallel, parallelize_module,
    )

    tp_mesh = mesh["model"]
    tp = tp_mesh.size()
    plan, matched = {}, []
    for name, m, kind in _tp_modules(model, tp):
        prefix = f"{name}." if name else ""
        first, second = _TP_PAIRS[0] if kind == "attn" else _TP_PAIRS[1]
        if kind == "attn":
            heads = m.num_heads
            with torch.no_grad():
                m.qkv.weight.copy_(_heads_first(m.qkv.weight, heads, tp))
                if m.qkv.bias is not None:
                    m.qkv.bias.copy_(_heads_first(m.qkv.bias, heads, tp))
            m.tp_qkv_heads = (heads, tp)
            m.num_heads = heads // tp
            if hasattr(m, "relative_position_bias_table"):
                m.head_range = (tp_mesh.get_local_rank() * m.num_heads,
                                m.num_heads, tp_mesh.get_group())
        plan[prefix + first] = ColwiseParallel(use_local_output=True)
        plan[prefix + second] = RowwiseParallel(input_layouts=Shard(-1),
                                                use_local_output=True)
        matched.append(name)
    if tp > 1 and not matched:
        names = [n for n, _ in model.named_parameters()][:8]
        raise ValueError(
            f"mesh has a model axis of size {tp} but no module matched the "
            f"tensor-parallel plan (qkv/proj attentions, fc1/fc2 MLPs); "
            f"first params: {names}")
    if plan:
        parallelize_module(model, tp_mesh, plan)
    model.tp_modules = matched
    return model


class _HeadColumns(torch.autograd.Function):
    """Columns [start, start + count) of a [rows, heads] table; the
    backward places the gradient in those columns and sums the table's
    gradient over the model group, so every rank holds all heads'."""

    @staticmethod
    def forward(ctx, table, start, count, group):
        ctx.shape, ctx.start, ctx.count, ctx.group = (table.shape, start,
                                                      count, group)
        return table[:, start:start + count]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[:, ctx.start:ctx.start + ctx.count] = g
        dist.all_reduce(full, group=ctx.group)
        return full, None, None, None


def head_columns(table: torch.Tensor, head_range) -> torch.Tensor:
    """The table's columns of this rank's heads (all of it without tensor
    parallelism)."""
    if head_range is None:
        return table
    return _HeadColumns.apply(table, *head_range)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A plain tensor of a DTensor's whole value (a collective); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def unpermute_qkv(model: nn.Module, state: Dict[str, torch.Tensor]) -> dict:
    """A full state dict of a tensor-parallel model in the layout of the
    unsplit model (qkv's rows back in (3, heads, head_dim) order), so that
    it loads into a model on any mesh."""
    return _qkv_rows(model, state, _heads_back)


def permute_qkv(model: nn.Module, state: Dict[str, torch.Tensor]) -> dict:
    """The inverse of `unpermute_qkv`: an unsplit model's full state dict
    in the tensor-parallel model's qkv row order."""
    return _qkv_rows(model, state, _heads_first)


def _qkv_rows(model, state, reorder):
    state = dict(state)
    for name, m in model.named_modules():
        heads_tp = getattr(m, "tp_qkv_heads", None)
        if heads_tp is None:
            continue
        prefix = f"{name}." if name else ""
        for key in (prefix + "qkv.weight", prefix + "qkv.bias"):
            if key in state:
                state[key] = reorder(state[key], *heads_tp)
    return state
