"""Distributed layers on ``torch.distributed``: the expert-parallel MoE
layer and ring attention, each rank running its shard, the mesh axis a
process group (``None``: one rank)."""

from .device_mesh import axis_index, axis_size, peer_rank  # noqa: F401
from .moe import (make_moe_layer, moe_ffn_local,  # noqa: F401
                  moe_reference, route, shard_rows, weights_from_numpy)
from .ring_attention import (make_ring_attention,  # noqa: F401
                             ring_attention_local)

__all__ = ["axis_index", "axis_size", "peer_rank", "make_moe_layer",
           "moe_ffn_local", "moe_reference", "route", "shard_rows",
           "weights_from_numpy", "make_ring_attention",
           "ring_attention_local"]
