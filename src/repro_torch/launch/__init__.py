"""repro_torch.launch — the shard mesh of the multi-device tiers, LM
serving (`launch/serve.py`) and LM training (`launch/train.py`)
(`repro/launch`, less the language-model meshes and the dry-run and
roofline tools)."""
from repro_torch.launch.mesh import (LOGICAL_DEVICES, ShardMesh,
                                     device_count, make_shard_mesh,
                                     serve_shard_count)

__all__ = ["LOGICAL_DEVICES", "ShardMesh", "device_count", "make_shard_mesh",
           "serve_shard_count"]
