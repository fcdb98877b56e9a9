"""repro_torch.launch — `repro/launch`: the shard mesh of the
multi-device tiers and the LM meshes with their collectives
(`launch/mesh.py`), LM serving (`launch/serve.py`), LM training
(`launch/train.py`), meta-tensor input specs (`launch/specs.py`), the
roofline — its analytic half and the count-based half that stands for
the reference's compile-based one (`launch/roofline.py`) — and the dry-run
tools: the sweep of every config × shape cell on a meta production mesh
(`launch/dryrun.py`), one cell's terms under overrides with a peak
measured on the card (`launch/perf.py`) and the tables of the records
(`launch/report.py`)."""
from repro_torch.launch.mesh import (LOGICAL_DEVICES, ShardMesh,
                                     device_count, make_shard_mesh,
                                     serve_shard_count)

__all__ = ["LOGICAL_DEVICES", "ShardMesh", "device_count", "make_shard_mesh",
           "serve_shard_count"]
