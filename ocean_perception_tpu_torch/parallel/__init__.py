"""Many cameras in one call, and one frame across several devices, driven
by one process (port of ``ocean_perception_tpu.parallel``)."""

from .mesh import Mesh, camera_sharding, make_mesh, replicated  # noqa: F401
from .sharded_pipeline import (  # noqa: F401
    FleetStats,
    create_fleet_frontend_state,
    multi_camera_frontend_step,
    multi_camera_step,
    sharded_perception_step,
)
from .spatial import sharded_enhance, strip_sharding  # noqa: F401
from .stereo_sharded import sharded_patchmatch  # noqa: F401
