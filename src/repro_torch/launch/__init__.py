"""repro_torch.launch — the shard mesh of the multi-device tiers, LM
serving (`launch/serve.py`), LM training (`launch/train.py`), meta-tensor
input specs (`launch/specs.py`) and the analytic roofline
(`launch/roofline.py`) (`repro/launch`, less the language-model meshes,
the dry-run tools and the roofline's compile-based half)."""
from repro_torch.launch.mesh import (LOGICAL_DEVICES, ShardMesh,
                                     device_count, make_shard_mesh,
                                     serve_shard_count)

__all__ = ["LOGICAL_DEVICES", "ShardMesh", "device_count", "make_shard_mesh",
           "serve_shard_count"]
