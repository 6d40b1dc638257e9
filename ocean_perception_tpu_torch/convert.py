"""Bridge from the JAX package's parameter objects to the port's.

This system has no learned weights: its "weights" are the configuration
dataclasses and the stereo rig, and its only carried state is the 12-vector
attenuation guess. The functions here read the JAX objects' fields by
attribute and ``np.asarray`` (duck-typed, so this module imports no JAX)
and return the port's frozen dataclasses and tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.cameras import PinholeCamera, StereoCamera
from .imaging.enhance import EnhanceParams
from .models.perception import PerceptionConfig


def _scalar(v) -> float:
    return float(np.asarray(v, dtype=np.float32))


def pinhole_camera_from_jax(cam) -> PinholeCamera:
    return PinholeCamera.create(
        _scalar(cam.fx), _scalar(cam.fy), _scalar(cam.cx), _scalar(cam.cy),
        int(cam.height), int(cam.width),
    )


def stereo_camera_from_jax(rig) -> StereoCamera:
    return StereoCamera.create(
        pinhole_camera_from_jax(rig.left), pinhole_camera_from_jax(rig.right),
        _scalar(rig.baseline),
    )


def enhance_params_from_jax(params) -> EnhanceParams:
    return EnhanceParams(**{f: getattr(params, f) for f in EnhanceParams.__dataclass_fields__})


def perception_config_from_jax(cfg) -> PerceptionConfig:
    """The port's config for a JAX ``PerceptionConfig``. The JAX fields that
    only steer TPU code paths (``scan_unroll``, ``use_pallas_*``) have no
    counterpart: the port has one path."""
    return PerceptionConfig(
        engine=str(cfg.engine),
        max_disp=int(cfg.max_disp),
        internal_scale=int(cfg.internal_scale),
        max_depth=float(cfg.max_depth),
        enhance=enhance_params_from_jax(cfg.enhance),
        run_enhance=bool(cfg.run_enhance),
        chunks=int(cfg.chunks),
    )


def beta_guess_from_numpy(beta, device=None) -> torch.Tensor:
    """The 12-vector attenuation state [a, b, c, d] (RGB) as a float32 tensor."""
    arr = np.asarray(beta, dtype=np.float32)
    if arr.shape != (12,):
        raise ValueError(f"beta_D guess must have shape (12,), got {arr.shape}")
    return torch.as_tensor(arr, device=device)
