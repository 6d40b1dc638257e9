"""Config/resource path resolution (reference: core/path_util.hpp:12-46); a
copy of ``ocean_perception_tpu.utils.paths``.

The reference roots everything at the $BM_VEHICLE_DIR env var; here the
equivalent is $OCEAN_TPU_DIR (defaulting to the repo root), with the same
helper names for config/shared-config addressing.
"""

from __future__ import annotations

import os

ENV_VAR = "OCEAN_TPU_DIR"


def vehicle_dir() -> str:
    root = os.environ.get(ENV_VAR)
    if root:
        return root
    # Repo root = two levels above this file's package.
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def join(*parts: str) -> str:
    return os.path.join(*parts)


def config_path(*parts: str) -> str:
    """<root>/config/... (reference config_path)."""
    return os.path.join(vehicle_dir(), "config", *parts)


def shared_config_path(name: str) -> str:
    """<root>/config/shared/<name>.yaml (rig calibration files)."""
    if not name.endswith(".yaml"):
        name = name + ".yaml"
    return config_path("shared", name)
