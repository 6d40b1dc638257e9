"""Offline dataset providers (reference: src/vehicle/dataset).

A copy of ``ocean_perception_tpu.datasets``.
"""

from .base import DataProvider, DataSource, SanityLimits  # noqa: F401
from .euroc import EurocDataset, EurocDataWriter  # noqa: F401
from .folder_stereo import FolderStereoDataset, HimbDataset, CaddyDataset, AcfrDataset  # noqa: F401
from .lcm_log import LcmLogDataset  # noqa: F401
from .util import get_dataset_by_name  # noqa: F401
