"""Device mesh, sharding rules, and multi-rank serving on
``torch.distributed`` (port of ``gstreamer_vit_tracker_tpu/parallel/``)."""

from . import mesh, serving, sharding  # noqa: F401
from .mesh import DATA_AXIS, MODEL_AXIS, factor_mesh, make_mesh  # noqa: F401
from .serving import ShardedStreamTracker  # noqa: F401
from .sharding import shard_batch, shard_params  # noqa: F401
