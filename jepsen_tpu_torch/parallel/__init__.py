"""Multi-device parallelism for the analysis plane — the port of
:mod:`jepsen_tpu.parallel`.

The data-parallel axis is the history batch: independent histories shard
across the devices of a :class:`~.mesh.Mesh` in this process, each device
runs the same checker on its rows, and only the verdict statistics
(:func:`~.mesh.verdict_stats`, K9) are reduced across devices.
"""

from .mesh import (Mesh, default_mesh, engine_default_mesh, shard_batch,
                   sharded_check, verdict_stats)

__all__ = ["Mesh", "default_mesh", "engine_default_mesh", "shard_batch",
           "sharded_check", "verdict_stats"]
