from .mesh import (  # noqa: F401
    Mesh,
    all_reduce_mean,
    init_distributed,
    make_mesh,
    rank_seed,
    replicate,
    shard_batch,
)
