"""Visual-inertial state estimation (port of ``ocean_perception_tpu.vio``).

- ``odometry``: Cauchy-robust LM pose optimization on SE(3) from 3D-2D
  correspondences (optimize_odometry.cpp parity).
- ``stereo_frontend``: tracker + odometry -> VoResult with status bitmask.
- ``imu_preintegration``: on-manifold IMU preintegration with bias Jacobians
  and covariance (replaces GTSAM PreintegratedCombinedMeasurements).
- ``ekf``: 15-DoF error-state EKF, Joseph-form updates, manifold pose update.
- ``smoother``: fixed-lag batch smoother over a keypose window.
- ``state_estimator``: host-side orchestration around the device steps.
- ``evaluation``: ATE/RPE of a trajectory against groundtruth (numpy).
"""

from .odometry import OdometryParams, OdometryResult, optimize_odometry  # noqa: F401
from .stereo_frontend import FrontendStatus, VoResult, StereoFrontend  # noqa: F401
from .imu_preintegration import ImuCalibration, PreintegratedImu, preintegrate  # noqa: F401
from .ekf import EkfParams, EkfState, ekf_initialize, ekf_predict, ekf_update_imu  # noqa: F401
from .evaluation import (  # noqa: F401
    AteResult,
    RpeResult,
    absolute_trajectory_error,
    align_umeyama,
    evaluate_trajectory,
    relative_pose_error,
)
