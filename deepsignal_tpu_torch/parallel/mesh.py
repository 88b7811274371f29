"""The (data, model) grid of ranks and its collectives (port of
deepsignal_tpu/parallel/mesh.py).

The JAX package puts all chips into one ``Mesh`` with axes ``("data",
"model")``: batches sharded along ``data``, parameters replicated except
the joint head's fc1 kernel, sharded along ``model`` (tensor
parallelism), and XLA inserts the collectives.  Here a rank is a process
with one GPU (``parallel/dist.py``), the grid is a ``Mesh`` of ranks, rank
r at (r // model, r % model), and the collectives are written out:

- ``data`` group (the ranks of one model index): each holds a contiguous
  block of the global batch (``local_block``); batch-norm statistics and
  the gradients are summed over it, and per-row results are gathered back
  to the global batch in rank order (``gather_rows``);
- ``model`` group (the ranks of one data index, which hold the same
  block): each holds ``1/model`` of fc1's output rows
  (``param_shardings``); its activation columns are all-gathered
  (``GatherColumns``) and the gradient of fc1's input summed
  (``CopyToModel``).

Without a process group ``make_mesh`` gives a 1 x 1 mesh with no groups,
and every collective here is the identity.  Each collective runs on the
tensor's own device: NCCL on the card, gloo on the CPU, or gloo on a card
(two ranks that share one card cannot use NCCL, which refuses two ranks on
one GPU; gloo reduces CUDA tensors through the host).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .dist import group_is_up, rank_and_world

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the one parameter sharded over the model axis, on its output rows
TP_PARAM = "joint_model.fc1.weight"


@dataclass
class Mesh:
    """A ``data`` x ``model`` grid of ranks, from this rank's side: its
    rank, the group of every rank (``group``) and the groups of its column
    (``data_group``: the ranks that share its model index) and of its row
    (``model_group``).  A group is None when no process group is up."""

    data: int
    model: int
    rank: int = 0
    group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 1) -> Mesh:
    """A (data, model) mesh over every rank of the default group.

    ``n_devices`` defaults to the group's world size (1 without a group)
    and must equal it: a rank outside the mesh would have no work.  A count
    not divisible by ``model_parallel`` raises ValueError, as in the JAX
    package.  Every rank must call this, in the same order as its other
    group calls: each group of the grid is made on every rank."""
    rank, world = rank_and_world()
    n = world if n_devices is None else n_devices
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel="
                         f"{model_parallel}")
    if n != world:
        raise ValueError(f"a mesh spans every rank of the group: {n} asked "
                         f"for, {world} in the group")
    data, model = n // model_parallel, model_parallel
    if not group_is_up():
        return Mesh(data, model)
    import torch.distributed as dist
    if model == 1:
        return Mesh(data, model, rank, dist.group.WORLD, dist.group.WORLD)
    data_group = model_group = None
    for j in range(model):  # the columns: one model index each
        g = dist.new_group([i * model + j for i in range(data)])
        if rank % model == j:
            data_group = g
    for i in range(data):  # the rows: one data index each
        g = dist.new_group([i * model + j for j in range(model)])
        if rank // model == i:
            model_group = g
    return Mesh(data, model, rank, dist.group.WORLD, data_group, model_group)


def mesh_is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans more than one rank."""
    return mesh.size > 1


def local_block(batch, rank: int, world: int):
    """This rank's contiguous block of a global batch (an array, or a dict
    of arrays with one leading batch axis): rows [rank * B/world, (rank + 1)
    * B/world).  Contiguous blocks keep a padded tail at the end of the
    reassembled global batch.  Raises ValueError when B does not divide."""
    first = next(iter(batch.values())) if isinstance(batch, dict) else batch
    n = first.shape[0]
    if n % world:
        raise ValueError(f"global batch {n} not divisible by {world} "
                         f"processes")
    lo = rank * (n // world)
    hi = lo + n // world
    if isinstance(batch, dict):
        return {k: v[lo:hi] for k, v in batch.items()}
    return batch[lo:hi]


def param_shardings(model: torch.nn.Module, mesh: Mesh) -> dict:
    """{parameter name: spec}, the spec naming the mesh axis of each
    parameter dimension: ``(MODEL_AXIS, None)`` for the joint head's fc1
    weight [out, in] when the mesh has a model axis (its output rows
    sharded), ``()`` (replicated) for every other parameter."""
    use_tp = mesh.shape[MODEL_AXIS] > 1
    return {name: ((MODEL_AXIS, None) if use_tp and name == TP_PARAM
                   else ())
            for name, _ in model.named_parameters()}


def shard_rows(full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a tensor sharded over the model axis."""
    n = full.shape[0]
    if n % mesh.model:
        raise ValueError(f"{n} rows not divisible by model_parallel="
                         f"{mesh.model}")
    rows = n // mesh.model
    return full[mesh.model_rank * rows:(mesh.model_rank + 1) * rows]


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad the batch axis up to a multiple (fixed-shape batching); returns
    (padded_array, valid_count)."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(arr, pad_width, mode="edge" if n > 0 else "constant"), n


# --------------------------------------------------------------------------
# collectives: the identity where the group is None


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group``; returns it."""
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors of ``t``'s shape, concatenated along ``dim`` in
    rank order."""
    if group is None:
        return t
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_rows(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch's rows of a per-row result, from every data rank's
    block in rank order (``host_local_rows``' counterpart)."""
    return t if mesh is None else all_gather_cat(t, mesh.data_group)


class AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the gradients over it too, so a
    value every rank's loss reads gets the gradient of the summed loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.clone(), ctx.group), None


class CopyToModel(torch.autograd.Function):
    """The identity on an input every model rank holds alike; its gradient
    is summed over the model group, since each rank's fc1 rows give only
    their share of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.clone(), ctx.group), None


class GatherColumns(torch.autograd.Function):
    """Concatenate every model rank's columns along the last axis.  Every
    model rank computes the same loss from the result, so the backward
    keeps this rank's columns of the gradient, unsummed."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.cols = index, x.shape[-1]
        return all_gather_cat(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.cols
        return grad[..., lo:lo + ctx.cols].contiguous(), None, None


def sum_over_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Differentiable sum over the data group (the global batch's sum of a
    per-block partial sum); the identity on a data axis of one rank."""
    if mesh is None or mesh.data == 1:
        return x
    return AllReduceSum.apply(x, mesh.data_group)


def model_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                          mesh: Mesh) -> torch.Tensor:
    """``F.linear(x, full_weight)`` from this rank's rows of the weight:
    the rank's output columns, all-gathered over the model group."""
    if mesh.model_group is None:
        return torch.nn.functional.linear(x, weight)
    x = CopyToModel.apply(x, mesh.model_group)
    part = torch.nn.functional.linear(x, weight)
    return GatherColumns.apply(part, mesh.model_group, mesh.model_rank)
