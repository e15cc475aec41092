"""Multi-device layouts on torch.distributed: meshes and sharding rules
(sharding.py), the process runtime and collectives (distributed.py) and
pipeline stages (pipeline.py). Counterpart of tinygpt_tpu/parallel."""

from tinygpt_tpu_torch.parallel.sharding import (
    cache_pspecs,
    data_pspecs,
    make_mesh,
    param_pspecs,
    shard_params,
)

__all__ = [
    "make_mesh",
    "param_pspecs",
    "cache_pspecs",
    "data_pspecs",
    "shard_params",
]
