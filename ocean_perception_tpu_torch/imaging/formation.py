"""Underwater image formation model (Sea-thru; Akkaynak & Treibitz); port of
``ocean_perception_tpu.imaging.formation``.

    I_c = J_c * exp(-beta_D_c(z) * z) + B_c * (1 - exp(-beta_B_c * z)),
    beta_D_c(z) = a_c*exp(b_c z) + c_c*exp(d_c z),  a, c >= 0, b, d <= 0.

Channel order is RGB (the reference stores BGR; each 3-block is reversed).
"""

from __future__ import annotations

import numpy as np
import torch

# Sea-thru D5 3374 defaults (enhance.cpp:44-48).
B_DEFAULT = np.array([0.0559, 0.115, 0.132], dtype=np.float32)
BETA_B_DEFAULT = np.array([1.11, 0.695, 0.358], dtype=np.float32)
JP_DEFAULT = np.array([0.05, 0.05, 0.05], dtype=np.float32)
BETA_DP_DEFAULT = np.array([0.891, 1.23, 1.17], dtype=np.float32)

# beta_D initial guesses (attenuation.hpp:12-29), packed X = [a, b, c, d].
BETA_GUESS_1 = np.array(  # "works well for D1, D2, D3"
    [1.1, 0.77, 0.85, 0.0, -0.30, -0.38, 2.9, 2.0, 1.4, -1.6, -1.9, -2.0],
    dtype=np.float32,
)
BETA_GUESS_2 = np.array(  # "works well for D5"
    [0.26, 0.088, 0.023, -0.08, -0.051, -0.032, 1.69, 1.04, 0.025, -2.3, -2.1, -0.039],
    dtype=np.float32,
)


def beta_d_of_z(X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """beta_D(z) per channel: X (12,) packed [a, b, c, d], z (...) -> (..., 3)."""
    a, b, c, d = X[0:3], X[3:6], X[6:9], X[9:12]
    zz = z[..., None]
    return a * torch.exp(b * zz) + c * torch.exp(d * zz)
