"""Process groups in place of the JAX package's mesh axes.

The JAX layers run inside ``shard_map`` over one named axis of a
``jax.sharding.Mesh`` and ask it for its size and their index
(``axis_size_compat``, ``lax.axis_index``; ``device_mesh.py:110-132``).
The port runs one process a shard, and the axis is a
``torch.distributed`` process group: ``axis_size`` and ``axis_index``
give the group's size and this process's rank in it. ``group=None`` is
an axis of one device (size 1, rank 0), as a one-device JAX mesh is:
every collective over it is the identity, and no process group need
exist.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

__all__ = ["axis_size", "axis_index", "peer_rank"]


def axis_size(group: Optional["dist.ProcessGroup"] = None) -> int:
    """Number of shards along the axis: the group's size, 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group: Optional["dist.ProcessGroup"] = None) -> int:
    """This process's shard index: its rank in the group, 0 for None."""
    return 0 if group is None else dist.get_rank(group)


def peer_rank(group: "dist.ProcessGroup", index: int) -> int:
    """The global rank of the group's shard ``index`` (what point-to-point
    calls address)."""
    return dist.get_global_rank(group, index)
