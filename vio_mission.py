#!/usr/bin/env python
"""Score the state estimator on ``chip_smoke.py`` phase 16's mission.

The shipped ``config/nodes/StateEstimatorNode.yaml`` on
``config/shared/Farmsim.yaml``, the mission of ``chip_smoke.vio_mission``
with the textured plane at a chosen disparity; prints the unaligned ATE
and the RPE over 0.5 s of the smoother trajectory (``vio/evaluation.py``)
for the port's ``StateEstimator`` on ``--device`` and, with ``--jax``, for
the JAX package's engine on the CPU, fed the same events.

    python vio_mission.py --disp 13.44544 --device cpu --jax

(13.44544 px is the plane at 5 m on the Farmsim rig: the shipped matcher's
whole-pixel disparities then bias every stereo depth by 3.4%.)
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

import chip_smoke as cs


def score(make_estimator, events, gt) -> dict:
    from ocean_perception_tpu_torch.vio.evaluation import evaluate_trajectory

    est = make_estimator()
    est.initialize(gt[0].timestamp, gt[0].world_T_body)
    traj = {}
    est.smoother_callbacks.append(
        lambda r: traj.__setitem__(est._last_smoother_t_ns, est.smoother_state().world_T_body))
    t0 = time.perf_counter()
    for kind, m in events:
        {"imu": est.receive_imu, "depth": est.receive_depth,
         "stereo": est.receive_stereo}[kind](m)
    ts = np.array(sorted(traj), np.int64)
    rep = evaluate_trajectory(ts, np.stack([traj[t] for t in ts]), gt, align="none",
                              rpe_deltas_s=[0.5])
    return dict(ate_rmse_m=rep["ate_rmse_m"], ate_max_m=rep["ate_max_m"],
                rpe_05s_m=rep["rpe"]["0.5s"]["trans_rmse_m"], poses=len(ts),
                seconds=round(time.perf_counter() - t0, 1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--disp", type=float, default=cs.VIO_DISP, help="the plane's disparity, px")
    ap.add_argument("--seconds", type=float, default=cs.VIO_SECONDS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jax", action="store_true", help="also the JAX engine on the CPU")
    args = ap.parse_args()

    from ocean_perception_tpu_torch.config.bindings import load_rig, load_state_estimator_params
    from ocean_perception_tpu_torch.config.yaml_parser import YamlParser
    from ocean_perception_tpu_torch.vio.state_estimator import StateEstimator

    parser = YamlParser(node_path=cs.VIO_YAML, shared_path=cs.FARMSIM_YAML)
    params, rig = load_state_estimator_params(parser), load_rig(parser)
    events, gt, n_frames, depth = cs.vio_mission(rig, params.n_gravity, args.seconds, args.disp)
    print(f"mission: {n_frames} frames, plane at {depth:.4f} m (disparity {args.disp} px)")
    print("port", args.device, score(lambda: StateEstimator(params, rig, device=args.device),
                                     events, gt))
    if args.jax:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from ocean_perception_tpu.config.bindings import load_rig as jax_rig
        from ocean_perception_tpu.config.bindings import \
            load_state_estimator_params as jax_params
        from ocean_perception_tpu.config.yaml_parser import YamlParser as JaxParser
        from ocean_perception_tpu.vio.state_estimator import StateEstimator as JaxEstimator

        jp = JaxParser(node_path=cs.VIO_YAML, shared_path=cs.FARMSIM_YAML)
        print("jax cpu", score(lambda: JaxEstimator(jax_params(jp), jax_rig(jp)), events, gt))


if __name__ == "__main__":
    main()
