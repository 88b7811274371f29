"""Process group and per-rank work sharding (port of
deepsignal_tpu/parallel/dist.py).

PyTorch's idiom replaces the JAX package's one process per host: one
process per GPU, launched by ``torchrun`` (``python -m
torch.distributed.run``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; ``init_distributed``
makes the ``torch.distributed`` group from them.

- inference: each rank streams a *disjoint* stride shard of the inputs
  (the sorted fast5 list, or the read-grouped batches of a feature TSV)
  and writes its own ``<result>.part<k>-of-<n>``; no collective runs, and
  ``merge_call_shards`` (or ``call_freq`` over the shards) joins them;
- training: the group is the mesh of ``parallel/mesh.py``.

The helpers here import ``torch.distributed`` only when they need the
group, so the host-only subcommands of the CLI never load it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Optional

# the variables torchrun sets for every rank it launches
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
# numbers the default groups this process makes, each keyed apart in the
# rendezvous store (init_distributed); process-wide, as the group itself is
_group_numbers = itertools.count(1)


def launched_by_torchrun() -> bool:
    """True when this process runs under torchrun's environment."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def group_is_up() -> bool:
    """True when a default ``torch.distributed`` group exists."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def init_distributed(device=None, backend: Optional[str] = None) -> tuple:
    """Make the default group from torchrun's environment; returns
    (rank, world size).

    Without torchrun's environment it is a no-op and returns (0, 1).  Under
    torchrun it makes the group even at ``WORLD_SIZE`` 1, as the JAX
    package's distributed start does whenever it is given a process
    count.  ``backend`` defaults to ``nccl`` for a CUDA ``device``
    (``None`` is ``cuda``) and ``gloo`` for the CPU.  No ``device_id`` is
    passed, so NCCL makes its communicator at the first collective, and
    ranks that issue none (inference) may share a card.  A group that is
    already up is kept as it is.

    Each group a process makes keys the rendezvous store (torchrun's,
    which outlives the group) under a prefix of its own: a group made
    again after the last one was destroyed would otherwise read its
    keys, and gloo, which connects its ranks as the group is made, would
    reach for the last group's addresses and fail or hang."""
    if group_is_up():
        return rank_and_world()
    if not launched_by_torchrun():
        return 0, 1
    import torch
    import torch.distributed as dist
    if backend is None:
        cuda = torch.device("cuda" if device is None else device).type == \
            "cuda"
        backend = "nccl" if cuda else "gloo"
    store, rank, world = next(dist.rendezvous("env://"))
    prefix = f"deepsignal_pg{next(_group_numbers)}"
    dist.init_process_group(backend=backend, rank=rank, world_size=world,
                            store=dist.PrefixStore(prefix, store))
    return rank_and_world()


@contextlib.contextmanager
def distributed(device=None, backend: Optional[str] = None):
    """``init_distributed`` for the length of the block; the group this
    call made is destroyed when the block ends, also on an error, so that
    no rank waits for it at exit.  Yields (rank, world size)."""
    made = not group_is_up() and launched_by_torchrun()
    try:
        yield init_distributed(device, backend)
    finally:
        if made and group_is_up():
            import torch.distributed as dist
            dist.destroy_process_group()


def barrier(device) -> None:
    """Wait until every rank of the default group gets here (a summed
    zero on ``device``, so that NCCL uses the rank's own card); returns at
    once without a group."""
    if group_is_up():
        import torch
        import torch.distributed as dist
        dist.all_reduce(torch.zeros(1, device=device))


def run_on_lead(fn, *args, device=None):
    """``fn(*args)`` on rank 0 alone, its result broadcast to every rank,
    which waits for it (``device``: the rank's card under NCCL).  Without a
    group, ``fn(*args)``."""
    if not group_is_up():
        return fn(*args)
    import torch.distributed as dist
    out = [fn(*args) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(
        out, src=0, device=device if dist.get_backend() == "nccl" else None)
    return out[0]


def rank_and_world() -> tuple:
    """(rank, world size) of the default group; (0, 1) when none is up."""
    if not group_is_up():
        return 0, 1
    import torch.distributed as dist
    return dist.get_rank(), dist.get_world_size()


def _or_group(process_id: Optional[int], num_processes: Optional[int]):
    """The arguments, each None replaced by the group's value."""
    if process_id is None or num_processes is None:
        rank, world = rank_and_world()
        process_id = rank if process_id is None else process_id
        num_processes = world if num_processes is None else num_processes
    return process_id, num_processes


def shard_file_list(files: list, process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> list:
    """Deterministic per-rank stride partition of the input file list.

    Sorted first so every rank computes the same global order; stride (not
    contiguous blocks) so ranks see statistically similar read-length
    mixes.  The defaults are the group's rank and world size."""
    process_id, num_processes = _or_group(process_id, num_processes)
    return sorted(files)[process_id::num_processes]


def shard_output_path(path: str, process_id: Optional[int] = None,
                      num_processes: Optional[int] = None) -> str:
    """Per-rank output shard name: <path>.part<k>-of-<n> (one process:
    unchanged)."""
    process_id, num_processes = _or_group(process_id, num_processes)
    if num_processes == 1:
        return path
    return f"{path}.part{process_id}-of-{num_processes}"


def merge_call_shards(base_path: str, num_processes: int,
                      remove_shards: bool = False) -> str:
    """Concatenate the per-rank call-TSV shards into the final file."""
    with open(base_path, "w") as wf:
        for k in range(num_processes):
            shard = f"{base_path}.part{k}-of-{num_processes}"
            with open(shard, "r") as rf:
                for line in rf:
                    wf.write(line)
            if remove_shards:
                os.remove(shard)
    return base_path
