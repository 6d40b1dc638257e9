"""Image-folder stereo datasets: HIMB / CADDY / ACFR.

Reference parity: dataset/{himb,caddy,acfr}_dataset.{hpp,cpp} — underwater
stereo image folders with no clocks: timestamps are synthesized at 10 Hz
(1e8·i ns, himb_dataset.cpp:23). Each dataset differs only in folder naming;
``FolderStereoDataset`` covers all with configurable subfolders/patterns.

A copy of ``ocean_perception_tpu.datasets.folder_stereo``.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

from .base import DataProvider, StereoDatasetItem

SYNTH_PERIOD_NS = 100_000_000  # 10 Hz


class FolderStereoDataset(DataProvider):
    def __init__(
        self,
        toplevel_path: str,
        left_subfolder: str = "left",
        right_subfolder: str = "right",
        extensions: tuple = ("png", "jpg", "jpeg", "tif"),
    ):
        super().__init__()
        left_dir = os.path.join(toplevel_path, left_subfolder)
        right_dir = os.path.join(toplevel_path, right_subfolder)
        lefts = self._list_images(left_dir, extensions)
        rights = self._list_images(right_dir, extensions)
        n = min(len(lefts), len(rights))
        if n == 0:
            raise FileNotFoundError(
                f"no stereo images under {left_dir} / {right_dir}"
            )
        self.stereo_data = [
            StereoDatasetItem((i + 1) * SYNTH_PERIOD_NS, lefts[i], rights[i])
            for i in range(n)
        ]

    @staticmethod
    def _list_images(folder: str, extensions) -> List[str]:
        out: List[str] = []
        for ext in extensions:
            out.extend(glob.glob(os.path.join(folder, f"*.{ext}")))
        return sorted(out)


class HimbDataset(FolderStereoDataset):
    """HIMB underwater stereo (reference himb_dataset.hpp)."""

    def __init__(self, toplevel_path: str):
        super().__init__(toplevel_path, "left", "right")


class CaddyDataset(FolderStereoDataset):
    """CADDY diver-interaction stereo (reference caddy_dataset.hpp)."""

    def __init__(self, toplevel_path: str):
        super().__init__(toplevel_path, "left", "right")


class AcfrDataset(FolderStereoDataset):
    """ACFR marine survey stereo (reference acfr_dataset.hpp)."""

    def __init__(self, toplevel_path: str):
        super().__init__(toplevel_path, "left", "right")
