"""Motion planning, a copy of ``ocean_perception_tpu.planning`` (reference:
src/vehicle/rrt — explicitly abandoned there, README.md:54; kept at parity
as a working skeleton)."""

from .rrt import RrtStar, RrtParams  # noqa: F401
