"""SPMD scaling over ``torch.distributed``: process meshes, replica and time
sharding, collectives, and streaming from the host."""

from ..utils import spans as _spans

# The subpackage's imports: a set-up span of the process.
with _spans.setup_span("setup.import"):
    from .mesh import (
        Mesh,
        NamedSharding,
        P,
        all_gather,
        all_reduce,
        gather,
        init_distributed,
        make_mesh,
        replica_sharding,
        send_recv,
        shard,
        shard_replicas,
    )
    from .pipelined import lgssm_smooth_pipelined
    from .reductions import all_converged, global_sum
    from .streaming import StreamingSession, stream_filter
    from .time_sharded import lgssm_smooth_time_sharded, mv_lgssm_smooth_time_sharded

__all__ = [
    "init_distributed",
    "make_mesh",
    "Mesh",
    "replica_sharding",
    "shard_replicas",
    "shard",
    "gather",
    "NamedSharding",
    "P",
    "all_gather",
    "all_reduce",
    "send_recv",
    "lgssm_smooth_pipelined",
    "lgssm_smooth_time_sharded",
    "mv_lgssm_smooth_time_sharded",
    "StreamingSession",
    "stream_filter",
    "global_sum",
    "all_converged",
]
