"""Dataset factory (reference: dataset/dataset_util.hpp GetDatasetByName).

A copy of ``ocean_perception_tpu.datasets.util``.
"""

from __future__ import annotations

from .base import DataProvider
from .euroc import EurocDataset
from .folder_stereo import AcfrDataset, CaddyDataset, HimbDataset
from .lcm_log import LcmLogDataset

_DATASETS = {
    "euroc": EurocDataset,
    "farmsim": EurocDataset,   # FarmSim exports use the EuRoC layout
    "zed": EurocDataset,       # ZED recordings too
    "himb": HimbDataset,
    "caddy": CaddyDataset,
    "acfr": AcfrDataset,
    "lcmlog": LcmLogDataset,   # recorded session log (fabric/lcm_log.py)
    "log": LcmLogDataset,
}


def get_dataset_by_name(name: str, path: str) -> DataProvider:
    key = name.lower()
    if key not in _DATASETS:
        raise ValueError(f"unknown dataset '{name}'; options: {sorted(_DATASETS)}")
    return _DATASETS[key](path)
