"""Core math and data primitives (port of ``ocean_perception_tpu.core``)."""

from .time import (  # noqa: F401
    TIMESTAMP_MIN,
    TIMESTAMP_MAX,
    to_seconds,
    to_timestamp,
)
from .se3 import (  # noqa: F401
    skew,
    so3_exp,
    so3_log,
    se3_exp,
    se3_log,
    se3_inverse,
    se3_compose,
    se3_transform,
    gravity_axis,
)
from .cameras import PinholeCamera, StereoCamera  # noqa: F401
