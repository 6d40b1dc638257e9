#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's entry points at the bench's full width (1280x720 RGB,
max_disp=128, internal_scale=2, enhancement on) on synthetic scenes of known
disparity and motion, in phases:

1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles the hand-written kernels from ``csrc/`` and, beside
   them, a pointer chase that measures the latency of a dependent load
   from L2 (run once before phase 3);
3. the cost volume and the PatchMatch match kernel ``pm_match`` (the whole
   one-side match in one launch) against their plain PyTorch twins on the
   card, at the shapes the 720p path gives them (bit-identical; the match in
   bf16 and float32, on the path's seed and on an adversarial seed whose
   lookups tie and clamp and whose mask fires), with their times, bounds
   and the match's chain of dependent round trips (below); then the
   Sea-thru fit kernel ``sea_thru_fit`` (a whole LM fit a block, one launch
   a fit) on the two fits of one perception step: x, error, lambda and the
   accepted steps equal bit for bit to its plain version run on the card
   (the fits' loop, ``ops/lm.py::lm_solve``, with the LM kernels' twins: no
   kernel of the port) and to that loop with ``lm_solve_small`` and
   ``lm_row_sum`` (``require_same_fit``; each camera of a batch alone as in
   its batch too), with its times, the loop's call times, its bound and its
   chain of dependent operations (``fit_bound``, ``fit_chain``), and on the
   adversarial fits of ``fit_adversarial`` (no valid sample, a sample at
   z = inf, zero ranges, a start far off, a start whose model overflows);
   then the LM kernels, ``lm_solve_small`` (the damped normal equations and
   their solve, a block a system) and ``lm_row_sum`` (the error sums), which
   the step no longer launches, on the same fits run by their loop with the
   kernels (``record_fit_loops``): against their twins on the first launch
   of each shape (bit-identical), with their times, bounds and the time of
   one PyTorch call of the same function (``torch.linalg.solve_ex`` on the
   damped systems, ``torch.sum``); ``lm_solve_small`` also on an adversarial
   batch (``lm_adversarial``: a pivot tie, a zero column, a NaN, columns
   over 10^8) at each of those shapes, bit for bit with its NaNs in the same
   places, and with its chain of dependent operations beside its bound;
4. ``perception_step`` end to end: three runs of 8 frames, checking the
   kernels' launch counts (``sea_thru_fit`` twice a frame), finite outputs
   and the disparity against the scene's truth, and every fit of the 8
   frames held to its plain version and the LM kernels' loop as in phase 3
   (``check_fits``; phase 7 the same); its host syncs a frame (there must be
   none); then the
   whole step captured in one CUDA graph and replayed over the 8 frames
   (ms/frame beside the call path's, and the match's share of the graph
   frame; its disparity equal to the call path's); then the call time of
   each stage;
5. the same perception frame through the port on the CPU, against the card;
6. ``build_volumes`` (bf16 and float32) and ``pm_match_strip`` (the match
   over the two strip layouts) against their twins at the 720p shapes
   (bit-identical, the match as in phase 3, and equal to the (H, W, D)
   match), with their times;
7. ``perception_step`` with ``use_strip_volumes=True``, as in phase 4 (runs,
   launch counts, no host sync, graph replay and the match's share), with a
   disparity equal bit for bit to phase 4's on the same frame;
8. the other stereo configurations at 720p: the SGM and WTA engines of
   ``perception_step`` and two-sided and ZNCC PatchMatch (through
   ``estimate_disparity`` at the perception step's half resolution, then
   upsampled as the step does): ms/frame, accuracy, and one frame each
   against the CPU; then two-sided and ZNCC PatchMatch on N_CAMERAS
   cameras in one call (``pm_match`` once a side a call), each camera's
   disparity equal to its one-camera call's, ms a call beside the one
   camera's ms/frame;
9. the LK kernel ``lk_track`` (every level of one direction in one launch)
   against its twin on one ``full_frontend_step`` frame's recorded inputs at
   720p (K=200 slots, a 4-frame ring, 4 levels, window 21, forward and
   backward; bit-identical), with its times, its bound and chain of
   dependent operations, and the Gauss-Newton steps the points take on
   each level;
10. ``full_frontend_step`` end to end (tracker with the pyramid ring, stripe
   matcher, landmark graph) over 8 frames of a sequence that moves -2 px a
   frame with an 8 px stereo disparity: launch counts, finite outputs, the
   track error against the known motion, the stripe disparities, ms/frame,
   the tracker's share, host syncs per frame (at most FRONTEND_SYNCS, each
   printed with its place in the port) and the stage times; then the whole
   step captured in one CUDA graph and replayed over the same 8 frames, its
   outputs fed back as the next frame's state (ms/frame beside the call
   path's; the first and last frames' labels, slot ids and pixels equal to
   the call path's) and LK's share of its device time;
11. the same frontend frame through the port on the CPU, against the card;
12. ``perception_step`` on a batch of N_CAMERAS cameras in one call, each
   its own frame of the sequence (``make_inputs(canvas, i)``), on the (H, W,
   D) volume, on the strip layouts and at the farm point
   (``internal_scale=4``): the batched kernels against their batched twins
   at the batch's shapes (bit-identical) with their times and bounds beside
   their one-camera times, and the farm point's (``cost_volume`` and
   ``pm_match`` at its quarter-resolution shapes, checked as in phase 3 and
   not timed); then each configuration's batched step, whose
   every camera's disparity and depth must equal the one-camera step's on
   that frame bit for bit and whose enhanced image must stay within the
   enhance tolerance (below), with each kernel launched once a call, no
   host sync, every fit held as in phase 4 (and ``sea_thru_fit`` at B=4
   checked and timed as in phase 3 on the (H, W, D) configuration's fits),
   and its CUDA graph's replay equal to the call path; ms per
   call by calls and by graph beside the one-camera graph frame, fps per
   GPU, the CUDA kernels a call runs at one camera and at N_CAMERAS
   (``torch.profiler``, with the kernels whose count differs between the
   two, and the kernel nodes of the call captured in a CUDA graph), and the
   peak device memory of each;
13. the fleet frontend, as a farm node dispatches it:
   ``multi_camera_frontend_step`` on N_CAMERAS cameras of uint8 mono frames
   at the farm point (``internal_scale=4``, ``mesher_scale=1``,
   ``ObjectMesherDeviceParams()``), each camera its own phase of the moving
   canvas (FLEET_PHASE frames apart): ``lk_track`` at B=N_CAMERAS against
   its batched twin (bit-identical) with its times and bound beside the one
   camera's (phase 9); 8 timed calls (launch counts, per-camera track error
   and stripe disparities); each camera's disparity map, depth, labels,
   slot ids and alive set equal to its one-camera ``full_frontend_step`` on
   the card at every timed frame, its pixels within 1e-3 px on >= 99% of
   alive slots (the run prints where they are equal bit for bit); no host
   sync; the call replayed as one CUDA graph with its outputs fed back
   (first and last frames equal to the call path's); ms a call by calls
   and by graph, fps per GPU beside the one-camera frontend's graph frame
   at the same point, CUDA kernels a call (profiler; graph nodes), peak
   memory, and the call times of a call and of its dense and mesher
   halves, at one camera and at N_CAMERAS. Each camera's enhanced image is
   held to its one-camera call's at every timed call within the enhance
   tolerance (below; the run prints where it is bit-identical);
   ``sea_thru_fit`` and the LM kernels are checked and timed at the fleet's
   shapes as in phase 3, and every fit of the 8 timed calls is held as in
   phase 4;
14. the farm perception node (``fabric/nodes/farm_perception_node.py``)
   over an ``InProcessBus``: (a) built by ``from_config`` from the shipped
   ``config/nodes/FarmPerceptionNode.yaml`` and ``config/shared/Farmsim.yaml``
   (4 cameras of 672x376, PatchMatch, ``internal_scale`` 4, ``mesher_scale``
   2), NODE_STEPS fleet frames of uint8 mono stereo messages, each camera
   its own phase of the canvas: every frame stepped, no step failed, every
   camera meshed, and each mesh received equal bit for bit to a direct loop
   of ``multi_camera_frontend_step`` + ``build_meshes`` on the same frames;
   (b) the same at phase 13's farm point (1280x720, the shipped mesher
   params and ``mesher_scale``): NODE_TIMED timed fleet steps, from publish
   to the step's last mesh, as fleet steps/s and camera-fps, with the
   in-process publish and the node thread's time in its steps apart,
   beside the direct calls on the same frames on the main thread and on a
   thread of their own (their ``build_meshes`` apart): the node's own cost
   is its wall time less the publish and the threaded direct calls; then
   camera 3 falls silent for DEAD_STEPS
   steps: the others are still meshed and each step counts a stale fill;
15. the object mesher node (``fabric/nodes/object_mesher_node.py``) built
   by ``from_config`` from the shipped ``config/nodes/ObjectMesherNode.yaml``
   on a 1280x720 rig, so its ``mesher_input_height`` downscale runs:
   MESHER_FRAMES raw float frames, the meshes equal bit for bit to a direct
   ``ObjectMesher`` on the downscaled frames, then the same frames through
   the shared-memory rings (``fabric/shm_ring.py``), the same meshes;
   frames/s;
16. the state estimator (``vio/state_estimator.py::StateEstimator``) built
   by the port's loaders from the shipped
   ``config/nodes/StateEstimatorNode.yaml`` and ``config/shared/Farmsim.yaml``
   (a 672x376 rig; window 40, 6 Gauss-Newton iterations, 16 landmark
   columns, 256 IMU samples a keypose; tracker capacity 200, LK window 21
   on 5 levels, ``max_disp`` 128), on a mission made here with numpy and
   scipy: a textured plane at the depth of a 14 px disparity, the
   bounded-sin motion of ``tests/synthetic_vio.py``, 10 Hz stereo, 200 Hz
   IMU and 2 Hz depth for 30 s (60 keyposes; the window slides 20 times).
   It checks ``lk_track``'s launches (2 a frame, no other kernel), the host
   syncs a frame, an IMU sample, a smoother update and a slide (none above
   the counts ``vio/state_estimator.py`` states), every tensor of the window
   and the EKF state on the card after the run, the smoother trajectory's
   ATE against the groundtruth (unaligned, below VIO_MAX_ATE) and RPE
   (``vio/evaluation.py``), the first VIO_CPU_FRAMES frames again through
   the port on the CPU (modes, VO statuses and keyposes equal, smoother
   poses within VIO_CPU_TOL), and ``lk_track`` against its twin on one
   frame's recorded calls at the mission's shapes (bit-identical); it prints
   the frontend ms a frame, the smoother-update ms and the filter-step ms
   (CUDA events around each call; p50 and p95), the syncs and their sites,
   and the peak device memory;
17. the VIO deployment on phase 16's mission, at the same full size: (a)
   ``StateEstimatorNode.from_config`` (``fabric/nodes/state_estimator_node.py``)
   on the card over an ``InProcessBus``, the init pose then the mission's
   IMU, depth and float32 stereo messages in phase 16's order: ``lk_track``
   2 launches a frame and no other kernel, its smoother poses equal phase
   16's bit for bit (the same engine, inputs and order), the filter and
   smoother poses published, the host syncs a frame and an IMU sample from
   frame VIO_WARMUP on (a published filter pose is one read-back), node ms
   a frame (host clock around a stereo publish) and the ATE; ``lk_track``
   against its twin on one node frame's calls (bit-identical); (b) the node
   saves with ``save_estimator`` at the first smoother update after
   VIO_SAVE_SLIDES slides (its ms and the file's size), a fresh node loads
   it (window and EKF equal the saved ones bit for bit, every tensor on the
   card) and plays the rest of the mission: ATE below VIO_MAX_ATE; (c) the
   mission written as an LCM log (``LcmLogWriter``, ``to_lcm``; frames as
   8-bit ``image_t``) and played by ``dataset_player.run("lcmlog", ...)`` on
   the card at speed 0: every frame played, frames/s, host syncs a frame
   (the engine's and the player's filter pose), ATE below VIO_MAX_ATE; (d)
   ``ThreadedStateEstimator`` on the card (its default stereo queue of 4
   frames) fed the mission at VIO_THREAD_SPEED times real time: no worker
   exception (recorded by wrapping the engine's entry points; the wrapper
   itself prints and goes on), ``lk_track`` 2 launches a frame the vision
   thread took and no other kernel, the longest gap between two filter
   outputs from frame VIO_WARMUP on below VIO_MAX_FILTER_GAP_MS (the first
   frames make each thread's one-time CUDA set-up), ATE below VIO_MAX_ATE;
   it prints the filter step's p50 and p95 (host clock), the longest gap
   while a smoother update is in flight and the garbage collections while
   the threads ran; (e) ``trilaterate``
   (``vio/trilateration.py``) on the card in float64 and float32, 8 beacons
   with one masked: 20 ``lm_solve_small`` and 22 ``lm_row_sum`` launches,
   each against its twin bit for bit (float64: the kernels' double build),
   with their times beside ``torch.linalg.solve_ex`` and ``torch.sum``, and
   the fix against the CPU's;
18. one frame across several devices, each played by this card (every mesh
   entry ``cuda:0``, each with a CUDA stream of its own: the exchanges are
   ordered by events between streams of one card, and a copy between two
   cards is not exercised), at 720p with N in SHARD_BLOCKS blocks:
   ``sharded_patchmatch`` at the step's half resolution (D=64, bf16, 16
   x-strips, halo 5) with every ``pm_pass`` it launched against its twin
   on the same inputs (bit-identical), and again on an adversarial seed
   and on a tie volume of the same shapes (``adversarial_block_args``),
   the passes' byte bound beside the line bytes their walks read, its
   maps equal bit for bit to the
   one-device engine with ``chunks_y = N``, ``cost_volume`` N and
   ``pm_pass`` 12 N launches; ``sharded_perception_step`` (the main path
   of this phase: launches ``cost_volume`` N, ``pm_pass`` 12 N,
   ``sea_thru_fit`` 2, ``pm_match`` none; every fit held as in phase 4)
   with its disparity and depth equal bit for bit to ``perception_step``
   with ``chunks_y = N``
   and its enhanced image within the enhance tolerance (below);
   ``pm_pass``'s device time a launch by kind of pass (profiler, through
   ``utils/profiling.trace``, whose trace also names each block's work)
   and the sharded match's device time (summed, and busy: the union);
   ms a frame by calls of the sharded step and match against the
   one-device ones; then the camera split, N_CAMERAS cameras over
   SHARD_ENTRIES entries: ``multi_camera_step`` (disparity, depth and
   FleetStats equal to the one-card call bit for bit, ms a call) and
   ``multi_camera_frontend_step`` over 3 fleet frames at the farm point
   (every output bit-identical, or a float within 1e-3); and the ported
   ``dryrun_multichip`` on 4 entries;
19. fiducial relocalization on the card: (a) the fiducial localizer node
   (``fabric/nodes/fiducial_localizer_node.py``) built by ``from_config``
   from the shipped ``config/nodes/FiducialLocalizerNode.yaml`` and
   ``config/shared/Farmsim.yaml`` (672x376, tags 0 and 1 of 0.19 m, 0.5 m
   apart) over an ``InProcessBus``, FID_FRAMES stereo frames FID_PERIOD_NS
   apart (each past the rate gate), rendered here (``render_tags``, a ray
   cast over ``render_tag``; FID_NOISE) from a camera moving over the tags
   at 0.9-1.2 m, tilted up to 3 degrees: a fix on every frame, within
   FID_MAX_T m and FID_MAX_R rad of the truth and FID_CPU_TOL of the
   port's CPU solve on the same detections, no kernel of the port launched
   (the path has none); it prints the host's detect ms, the solve's ms on
   the card (CUDA events; the first fix and p50), the CUDA graphs captured
   and the host syncs a fix; then one frame from FID_FAR m, printed with
   its error and whether it was published (the 2-tag map's known
   weakness, not bounded); (b) the fix closed into the state estimator
   node on the card (the shipped ``StateEstimatorNode.yaml``, keyposes held
   off): 2 s of IMU at rest biased by FID_IMU_BIAS drift the filter past
   0.1 m, one sighting on a channel of its own (pose sigmas 0.01) snaps it
   within FID_MAX_SNAP m of the truth; the ms from publish to the snapped
   filter state;
20. the LK tracker's two options on ``full_frontend_step`` at 720p with the
   frontend's tracker at full width (window 21, 4 levels, 200 landmarks),
   each as phase 10 runs the frontend (4 warm-up frames, 8 timed: launches,
   median |track error| < 0.1 px, >= 50 alive, no host sync, the frame as
   one CUDA graph equal to the call path): (a) the unbounded walk
   (``search_slack=0``) on phase 10's sequence, ``lk_track`` 2 launches a
   frame, both of one frame's calls bit-identical to ``lk_track_plain``,
   with its times, bound and chain beside the slack mode's; (b) the coarse
   start (``coarse_init``, search 12, patch 9, the backward check over the
   LK_FAR_BWD_LEVELS finest levels) on a sequence moving LK_FAR_SHIFT px a
   frame, beyond the default walk's reach: ``lk_coarse_match`` 1 launch a
   frame and ``lk_track`` 2, one frame's calls bit-identical to their
   twins, the times, bounds and chains of both, and LK's share of the graph
   frame from these three launches' device times; the default
   parameters on the same sequence, printed, not bounded; (c) the fleet,
   ``multi_camera_frontend_step`` on N_CAMERAS cameras of uint8 mono 720p
   at the farm point, a keyframe call and a tracked call with each option:
   the launches a call those of one camera's call, each camera against its
   one-camera call by phase 13's rule.

The enhanced image of a batched camera is held to the one-camera step's as
the port's CPU tests hold it to the reference: the median and the 99.9th
percentile of |batched - single| at most twice those of the change the
one-camera enhancement shows when its input moves by one ulp (its LM fits
are ill-conditioned). The port computes a camera's fits and filters in an
order that does not depend on the batch, so the images are expected to be
bit-identical; the tolerance is what the check holds.

A kernel's times, at each call shape of its path: its device time two ways,
``torch.profiler`` over 20 calls (``profiler_ms``; "not measured" where the
profiler recorded no device time) and CUDA events around the replay of a
CUDA graph that captured 20 calls (``graph_ms``); ``call_ms``, CUDA events
around one Python call, the host's enqueue included; and ``plain_ms``, the
plain twin's call time. ``device_ms`` (also ``ms``) is the profiler's time
where it measured, else the graph replay's, and ``device_method`` says which.

Any failure raises and exits nonzero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit; the one before that lists each kernel with its launches on its
own path (launch counts are zeroed just before each path is driven and read
just after), its error against the plain twin, its times, and its bound:
the larger of the bytes it must move over 3.35 TB/s and the operations it
must do over 67 TFLOP/s (float32), from this run's shapes (for the match,
the volume elements its plain twin reads on this run's seed); for the match
and ``lk_track`` also their chains of dependent operations (the match's in
units of the chase's latency in this run). ``lk_track``'s row also carries,
under ``vio``, its launches, times and bound on the state estimator's path
(phase 16), and under ``vio_node`` its launches on the node's (phase 17);
the LM kernels' launches are trilaterate's in float64 (phase 17 (e), their
path since the step's fits are one launch each), and their rows carry,
under ``trilaterate``, their float64 and float32 launches, times and bounds
there (operations at 34 TFLOP/s for float64, the H100 SXM's rate outside
the tensor cores); ``sea_thru_fit``'s row carries its shapes under
``fits``, its row at B=4 under ``batched`` and the fleet's under
``fleet``; ``lk_track``'s row carries its unbounded mode's launches,
times and bound under ``unbounded`` (phase 20 (a)), and
``lk_coarse_match``'s launches are those of phase 20 (b).

Run: ``python chip_smoke.py`` (needs one GPU and nvcc; no network).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import inspect
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from ocean_perception_tpu_torch.config.bindings import load_mesher_params, load_rig
from ocean_perception_tpu_torch.config.yaml_parser import YamlParser
from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu_torch.fabric import shm_ring
from ocean_perception_tpu_torch.fabric.messages import (DepthMessage, ImageMessage, ImuMessage,
                                                        PoseStampedMessage, ShmImageHeader,
                                                        StereoImageMessage)
from ocean_perception_tpu_torch.fabric.nodes import farm_perception_node as fpn
from ocean_perception_tpu_torch.fabric.nodes import object_mesher_node as omn
from ocean_perception_tpu_torch.fabric.pubsub import InProcessBus
from ocean_perception_tpu_torch.imaging.attenuation import beta_config, beta_lm_plain
from ocean_perception_tpu_torch.imaging.backscatter import backscatter_config, backscatter_lm_plain
from ocean_perception_tpu_torch.imaging.enhance import EnhanceParams, enhance_underwater
from ocean_perception_tpu_torch.imaging.formation import backscatter_start, beta_guesses
from ocean_perception_tpu_torch.mesher.landmark_graph import LandmarkGraph
from ocean_perception_tpu_torch.mesher.object_mesher import (ObjectMesher, ObjectMesherDeviceParams,
                                                           build_meshes)
from ocean_perception_tpu_torch.models.perception import (PerceptionConfig, full_frontend_step,
                                                          perception_step)
from ocean_perception_tpu_torch.ops import cuda, lm
from ocean_perception_tpu_torch.ops.image import (gradient_magnitude, image_pyramid, pyr_down,
                                                  resize, to_grayscale)
from ocean_perception_tpu_torch.ops.windows import fold_rings
from ocean_perception_tpu_torch.parallel import stereo_sharded
from ocean_perception_tpu_torch.parallel.dryrun import dryrun_multichip
from ocean_perception_tpu_torch.parallel.mesh import make_mesh
from ocean_perception_tpu_torch.parallel.sharded_pipeline import (create_fleet_frontend_state,
                                                                  multi_camera_frontend_step,
                                                                  multi_camera_step,
                                                                  prepare_frames,
                                                                  sharded_perception_step)
from ocean_perception_tpu_torch.parallel.stereo_sharded import sharded_patchmatch
from ocean_perception_tpu_torch.stereo import cost as sc
from ocean_perception_tpu_torch.stereo import patchmatch as pm
from ocean_perception_tpu_torch.stereo.api import estimate_disparity
from ocean_perception_tpu_torch.stereo.cost import cost_volume_plain
from ocean_perception_tpu_torch.tracking import lk
from ocean_perception_tpu_torch.tracking.stereo_tracker import StereoTrackerState
from ocean_perception_tpu_torch.utils import profiling

H, W = 720, 1280
MAX_DISP, SCALE = 128, 2
TRUE_DISP = 8
N_FRAMES = 8
N_ENGINE_FRAMES = 3
N_TIMED = 20
N_RUNS = 3  # timed runs of N_FRAMES frames of each perception layout
# Host syncs a full_frontend_step frame keeps (PERF.md, section 5).
FRONTEND_SYNCS = 0
# Launches of the Sea-thru fit kernel an enhanced frame (a batch of cameras
# too): the backscatter fit and the attenuation multi-start, one each.
PER_ENHANCE = {"sea_thru_fit": 2}
# Launches of the LM kernels on the fits' plain version with its kernels
# (fits_by_loop): a step each iteration of the two fits, and the error
# sums, two at each fit's start (lambda's diagonal and the start error) and
# one an iteration.
_ITERS = EnhanceParams().back_opt_iters + EnhanceParams().beta_opt_iters
PER_ENHANCE_LOOP = {"lm_solve_small": _ITERS, "lm_row_sum": _ITERS + 4}
# Launches of each kernel per frame of each path.
PER_FRAME = {"cost_volume": 1, "pm_match": 1, **PER_ENHANCE}
PER_STRIP_FRAME = {"build_volumes": 1, "pm_match_strip": 1, **PER_ENHANCE}
PER_FRONTEND_FRAME = dict(PER_FRAME, lk_track=2)  # forward and backward, 4 levels each
N_CAMERAS = 4  # phase 8's, 12's and 13's batch
FLEET_PHASE = 9  # phase 13: camera b's frame i is frame i + FLEET_PHASE * b of the sequence
FARM_SCALE = 4  # the farm point's internal_scale
SHIFT = 2  # frontend sequence: features move -SHIFT px a frame
PM_CU = "ocean_perception_tpu_torch/csrc/patchmatch.cu"
SOURCES = {
    "cost_volume": ("ocean_perception_tpu_torch/csrc/cost_volume.cu",
                    "ocean_perception_tpu/ops/pallas/cost_volume.py:97"),
    "pm_match": (PM_CU, "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:580 and "
                        "ocean_perception_tpu/ops/pallas/propagate.py:115"),
    "build_volumes": ("ocean_perception_tpu_torch/csrc/volume_build.cu",
                      "ocean_perception_tpu/ops/pallas/volume_build.py:242"),
    "pm_match_strip": (PM_CU, "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:634"),
    "pm_pass": (PM_CU, "ocean_perception_tpu/ops/pallas/propagate.py:115"),
    "lk_track": ("ocean_perception_tpu_torch/csrc/lk.cu",
                 "ocean_perception_tpu/ops/pallas/lk_prep.py:291 and "
                 "ocean_perception_tpu/ops/pallas/lk_iterate.py:160"),
    # No TPU kernel: the JAX package runs its coarse block match in XLA.
    "lk_coarse_match": ("ocean_perception_tpu_torch/csrc/lk_coarse.cu",
                        "none (XLA's _coarse_block_match, ocean_perception_tpu/tracking/lk.py:190, "
                        "and _coarse_block_match_ring, :978)"),
    # No TPU kernel: the JAX package leaves its LM's normal equations, solve
    # and sums to XLA.
    "lm_solve_small": ("ocean_perception_tpu_torch/csrc/lm_solve.cu",
                       "none (XLA's J.T @ J and jnp.linalg.solve, "
                       "ocean_perception_tpu/ops/lm.py:84-89)"),
    "lm_row_sum": ("ocean_perception_tpu_torch/csrc/lm_solve.cu",
                   "none (XLA's jnp.sum, ocean_perception_tpu/ops/lm.py:44)"),
    "sea_thru_fit": ("ocean_perception_tpu_torch/csrc/sea_thru_fit.cu",
                     "none (XLA's fori_loop LM, ocean_perception_tpu/ops/lm.py:48-106)"),
}
# H100 SXM peaks (NVIDIA's data sheet): memory rate, and the float32 and
# float64 rates outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
# Resident blocks an SM of pm_match's cooperative grid (csrc/patchmatch.cu,
# kMinBlocks).
MATCH_BLOCKS_PER_SM = 3
# A float32 add's latency on Hopper, in cycles, and the H100 SXM's boost
# clock: the time floor of a chain of dependent operations.
OP_CYCLES, CLOCK_HZ = 4, 1.98e9
# The unit of the match's chain of dependent round trips, measured in the
# run (l2_latency): one thread chases a random cycle of indices through a
# 4 MB buffer with loads that go to L2 (ld.global.cg), STEPS steps to bring
# the lines into L2, then the same STEPS again between two readings of the
# SM's clock (clock64) and of the global timer (%globaltimer, ns).
CHASE_STEPS = 4096
CHASE_CU = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}
__global__ void chase(const unsigned* next, int steps, unsigned* sink, long long* out) {
  unsigned i = 0;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  i = 0;
  const long long c0 = clock64(), t0 = global_ns();
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  const long long t1 = global_ns(), c1 = clock64();
  *sink = i;
  out[0] = c1 - c0;
  out[1] = t1 - t0;
}
extern "C" int opt_chase(const void* next, int steps, void* sink, void* out, void* stream) {
  chase<<<1, 1, 0, (cudaStream_t)stream>>>((const unsigned*)next, steps, (unsigned*)sink,
                                           (long long*)out);
  return (int)cudaGetLastError();
}
"""
CHASE_DIR = cuda._BUILD / "l2_chase"
# Dependent operations in one step of lk_track's walk (csrc/lk.cu, walk):
# the position to the offsets (3), floor and the tap's address (3), the
# shared load, two-tap products and sums over x then y (4), the residual
# (1), the 2x2 step (2) and the new position (1).
LK_STEP_CHAIN = 15
# Operations of a step of the unbounded walk (csrc/lk.cu, walk_unbounded),
# which the function needs once a patch row and once a patch column: the
# tent centre (add, subtract, two clamps), its floor and its two tents
# (subtract, absolute value, subtract, max each).
LK_UNBOUNDED_LINE_OPS = 13
# And once a patch element: the two-tap resampling (6 products, 3 sums), the
# difference, its two products with the gradients and their two row sums.
LK_UNBOUNDED_ELEMENT_OPS = 14


def make_canvas(extra: int = 200) -> np.ndarray:
    """Box-smoothed random canvas, ``extra`` px wider than a frame (bench.py's recipe)."""
    rng = np.random.default_rng(0)
    canvas = rng.random((H, W + extra)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    canvas = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, canvas)
    return np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, canvas)


def make_inputs(canvas: np.ndarray, i: int = 0,
                shift: int = SHIFT) -> tuple[np.ndarray, np.ndarray]:
    """Frame i of the synthetic 720p stereo sequence:
    left_i(y, x) = canvas(y, x + 100 + shift*i), right_i(y, x - 8) == left_i(y, x)."""
    x0 = 100 + shift * i
    left = canvas[:, x0 : x0 + W]
    right = canvas[:, x0 + TRUE_DISP : x0 + TRUE_DISP + W]
    tint = np.array([0.35, 0.75, 0.9], np.float32)
    left_rgb = np.clip(left[..., None] * tint + 0.05, 0, 1).astype(np.float32)
    right_rgb = np.clip(right[..., None] * tint + 0.05, 0, 1).astype(np.float32)
    return left_rgb, right_rgb


def make_mono_u8(canvas: np.ndarray, i: int, shape=None,
                 shift: int = SHIFT) -> tuple[np.ndarray, np.ndarray]:
    """Frame i of the sequence as a farm camera sends it, uint8 mono: the
    canvas of make_inputs, scaled to [0.05, 0.95] and quantized; ``shape``
    (h, w) crops a smaller frame (default H, W)."""
    h, w = shape or (H, W)
    x0 = 100 + shift * i

    def u8(a):
        return (np.clip(a[:h] * 0.9 + 0.05, 0, 1) * 255).astype(np.uint8)

    return u8(canvas[:, x0 : x0 + w]), u8(canvas[:, x0 + TRUE_DISP : x0 + TRUE_DISP + w])


def call_ms(fn, n: int = N_TIMED) -> float:
    """Median time of one call of fn() in ms over n runs, after two warm-ups:
    CUDA events recorded on an idle stream before and after the call, so the
    host's enqueue (the wrapper's checks, allocations and launches) is in it."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


KERNEL_RE = re.compile(r"(cost_volume|build_volumes|pm_match|pm_pass|lk_track|lk_coarse_match|"
                       r"lm_solve_small|lm_row_sum|sea_thru_fit)_kernel")


def launch_name(kernel: str) -> str | None:
    """The launch name of a kernel as the profiler names it, demangled or
    not: ``pm_match_kernel<float, (anonymous namespace)::RowStrips<float>, ...>``
    is ``pm_match_strip``, its Hwd form ``pm_match``; None for a
    kernel that no wrapper of ``ops/cuda.py`` launches."""
    m = KERNEL_RE.search(kernel)
    if m is None:
        return None
    strip = m.group(1).startswith("pm_") and re.search(r"(Row|Col)Strips", kernel)
    return m.group(1) + ("_strip" if strip else "")


def profiler_ms(launch: str, fn, n: int = N_TIMED) -> float | None:
    """Device time of one call's kernel in ms: ``torch.profiler`` over n
    calls of fn(), the kernels' device time in ``key_averages()`` over their
    count (the profiler may miss a launch of the n). None where it recorded
    no device time. Fails if the window ran a kernel of another launch name
    or more kernels than calls."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if launch_name(e.key) != launch:
            raise AssertionError(f"{launch}: the profiled window also ran {e.key!r}")
        total_us += e.device_time_total
        count += e.count
    if count == 0 or total_us <= 0:
        return None
    if count > n:
        raise AssertionError(f"{launch}: {count} kernels profiled over {n} calls")
    if count < n:
        print(f"[profiler] {launch}: {count} of {n} launches recorded")
    return total_us / 1e3 / count


def graph_ms(fn, n: int = N_TIMED, replays: int = 5) -> float:
    """Device time of one call of fn() in ms: CUDA events around the replay
    of a CUDA graph that captured n calls, so the host is out of it; the
    median over replays, over n."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def measure(launch: str, kernel, plain, plain_n: int = N_TIMED) -> dict:
    """One call shape of a kernel: its device time both ways, the time of
    one Python call, and its plain twin's call time."""
    return dict(profiler_ms=profiler_ms(launch, kernel), graph_ms=graph_ms(kernel),
                call_ms=call_ms(kernel), plain_ms=call_ms(plain, plain_n))


def summarize(calls: list) -> dict:
    """A kernel's timing columns, each the mean over its call shapes.
    ``device_ms`` (and ``ms``) is the profiler's where it measured every
    call, else the graph replay's; ``device_method`` says which."""
    def mean(key):
        return statistics.mean(c[key] for c in calls)

    profiled = all(c["profiler_ms"] is not None for c in calls)
    device = mean("profiler_ms") if profiled else mean("graph_ms")
    return dict(ms=device, device_ms=device,
                device_method="profiler" if profiled else "graph replay",
                profiler_ms=mean("profiler_ms") if profiled else "not measured",
                graph_ms=mean("graph_ms"), call_ms=mean("call_ms"), plain_ms=mean("plain_ms"))


def fmt_ms(v) -> str:
    """A time in ms, or "not measured" where a method gave none."""
    return "not measured" if v is None or isinstance(v, str) else f"{v:.5f} ms"


def times_line(t: dict) -> str:
    return (f"device {fmt_ms(t['profiler_ms'])} (profiler), {t['graph_ms']:.5f} ms (graph "
            f"replay); call {t['call_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms")


def adversarial_seed(shape, D: int, device, seed: int = 5):
    """Seeds of shape (..., H, W) and one (H, W) noise image on which the
    match's lookups tie and clamp and its mask fires: disparities on the
    half-integer grid over [0, D + 4), a quarter of them 0 (background), so
    past x - pr at the left edge and past D - 1; noise on the 1/64 grid, so
    that noise * 32, 16 and 8 keep the refreshed disparities on the
    half-integer grid."""
    rng = np.random.default_rng(seed)
    d = np.floor(rng.uniform(0, D + 4, shape) * 2).astype(np.float32) / 2
    d[rng.random(shape) < 0.25] = 0
    noise = (rng.integers(-64, 64, shape[-2:]) / 64).astype(np.float32)
    return torch.from_numpy(d).to(device), torch.from_numpy(noise).to(device)


def tie_volume(shape, dtype, device, seed: int = 7) -> torch.Tensor:
    """A volume whose costs tie often: 4 values, so most compares meet equal
    costs, and the mask's threshold improve * cost(0) falls on both sides."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.integers(1, 5, shape) / 4).astype(np.float32)).to(device, dtype)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def require_equal(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel differs from its plain twin "
                             f"(max |diff| {max_abs(a, b)})")


def require_launches(tag: str, launches: dict, per_frame: dict, frames: int) -> None:
    """Each kernel of per_frame ran per_frame[k] times a frame; every other
    kernel ran no time."""
    want = {k: per_frame.get(k, 0) * frames for k in launches}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} over {frames} frames, expected {want}")


def bound(nbytes: float, flops: float = 0.0, peak_ops: float = PEAK_F32_PER_S) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the rate of their type (float32 unless peak_ops says
    otherwise), whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_ops
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


class VolumeReads(torch.overrides.TorchFunctionMode):
    """Records which elements of the volumes a plain match reads: the
    storage offsets of every advanced index (``vol[cam, a, b, d]``) into a
    view of one of vols and of every ``torch.gather`` from one, each
    volume's offsets apart. A pass's reads where its loop bounds fail (the
    1-px frame, the last row or column of a scan) decide nothing and are
    left out; so are basic indices (the mask's cost(0), added by the
    caller)."""

    def __init__(self, vols, pr: int):
        super().__init__()
        self.vols = {v.data_ptr(): i for i, v in enumerate(vols)}
        self.pr = pr
        self.offsets = [[] for _ in vols]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        src = args[0] if args else None
        k = self.vols.get(src.data_ptr()) if isinstance(src, torch.Tensor) else None
        if k is not None and func is torch.Tensor.__getitem__ and isinstance(args[1], tuple) \
                and all(isinstance(i, torch.Tensor) for i in args[1]):
            index = torch.broadcast_tensors(*args[1])
            a, b = index[-3], index[-2]
            n, lanes, pr = src.shape[-3], src.shape[-2], self.pr
            used = (a >= pr) & (a <= n - pr - 2) & (b >= pr) & (b <= lanes - pr - 1)
            off = sum(i * st for i, st in zip(index, src.stride()))
            self.offsets[k].append(off[used])
        elif k is not None and func is torch.gather:
            assert args[1] in (-1, src.dim() - 1), "a gather along the disparity axis"
            index = args[2]
            grid = torch.meshgrid(*(torch.arange(m, device=index.device) for m in index.shape[:-1]),
                                  indexing="ij")
            off = sum(g[..., None] * st for g, st in zip(grid, src.stride())) + index * src.stride(-1)
            self.offsets[k].append(off.flatten())
        return func(*args, **kwargs)


def match_bound(C_row: torch.Tensor, C_col: torch.Tensor, seed, noise, p, spec: int,
                l2: dict) -> dict:
    """Bound of one match launch whose row passes read C_row and whose other
    reads go to C_col ((..., H, W, D) each, the same tensor for pm_match),
    on these seeds and noise; and its chain.
    Bytes: what must cross the card's memory in one launch. The seeds and
    the noise are read once and the outputs written once; of the volumes,
    each element the plain twin's reads need (``VolumeReads`` over
    ``_match_passes``, and cost(0) of every pixel for the mask), once a
    layout, however many passes read it. The fronts, 1.4 MB a pair at 720p,
    stay in the 50 MB L2 between passes and are not counted. The chain of dependent L2 round trips: a row pass
    stages its fronts (one trip, two with the refresh's lookups), then
    walks its chunk + 2*halo positions, spec of them a trip; a column pass
    reads its predecessor, then walks one position a trip; a block that
    takes more than one of a pass's work items (B cameras' items over at
    most MATCH_BLOCKS_PER_SM blocks an SM) walks them one after another;
    each grid barrier between passes is two (arrive, then see the release).
    A trip takes l2["ns"], the pointer chase's latency in this run."""
    *batch, H, W, D = C_col.shape
    B = int(np.prod(batch))
    vols = [C_row] if C_row.data_ptr() == C_col.data_ptr() else [C_row, C_col]
    reads = VolumeReads(vols, p.patch_radius)
    with reads:
        pm._match_passes(C_row, C_col, seed, noise, p)
    # The first read is the seeds' cost, which the first refresh replaces
    # before anything reads it.
    if reads.offsets[-1][0].numel() != B * H * W:
        raise AssertionError("the plain match no longer starts with the seed's cost")
    reads.offsets[-1].pop(0)
    cam, yy, xx = torch.meshgrid(*(torch.arange(n, device=C_col.device) for n in (B, H, W)),
                                 indexing="ij")
    C_flat = C_col.reshape(B, H, W, D)
    reads.offsets[-1].append((cam * C_flat.stride(0) + yy * C_flat.stride(1)
                              + xx * C_flat.stride(2)).flatten())
    elements = sum(int(torch.unique(torch.cat(o)).numel()) for o in reads.offsets)
    nbytes = B * H * W * (4 + 4) + H * W * 4 + elements * C_col.element_size()
    passes = 4 * p.iters
    trips = 2 * (passes - 1)
    items = {1: -(-H // 16) * sc._effective_chunks(W, p.chunks),  # kLanes rows an item
             0: -(-W // 128) * sc._effective_chunks(H, pm._strips(p, 0))}  # kColumns
    blocks = min(MATCH_BLOCKS_PER_SM * torch.cuda.get_device_properties(C_col.device)
                 .multi_processor_count, B * max(items.values()))
    for k in range(passes):
        axis = 1 if k % 2 == 0 else 0
        dim = W if axis == 1 else H
        w = dim // sc._effective_chunks(dim, pm._strips(p, axis)) + 2 * p.halo
        waves = -(-B * items[axis] // blocks)
        trips += waves * ((1 + (k % 4 == 0) + -(-w // spec)) if axis == 1 else 1 + w)
    return dict(**bound(nbytes), volume_elements=elements, chain_trips=trips,
                chain_ms=trips * l2["ns"] / 1e6)


def l2_latency(dev) -> dict:
    """The latency of a dependent load that hits L2 (CHASE_CU), the median
    over 3 runs, in cycles of the SM's clock and in ns."""
    n = 1 << 20
    order = np.random.default_rng(9).permutation(n)
    nxt = np.empty(n, np.uint32)
    nxt[order] = np.roll(order, -1)
    nxt_t = torch.from_numpy(nxt.view(np.int32)).to(dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    lib = ctypes.CDLL(str(CHASE_DIR / "chase.so"))
    lib.opt_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p]
    runs = []
    for _ in range(3):
        cuda._check(lib.opt_chase(nxt_t.data_ptr(), CHASE_STEPS, sink.data_ptr(), out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream), "chase")
        runs.append([v / CHASE_STEPS for v in out.tolist()])
    cycles, ns = statistics.median(r[0] for r in runs), statistics.median(r[1] for r in runs)
    print(f"[l2] pointer chase, a dependent L2 load: "
          + ", ".join(f"{c:.1f} cycles {t:.1f} ns" for c, t in runs)
          + f"; median {cycles:.1f} cycles, {ns:.1f} ns")
    return dict(cycles=cycles, ns=ns)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name} | {smi} | torch {torch.__version__} | CUDA {torch.version.cuda}")
    return name, smi


def phase_build() -> None:
    """The port's kernels and, beside them, the pointer chase."""
    t0 = time.perf_counter()
    CHASE_DIR.mkdir(parents=True, exist_ok=True)
    (CHASE_DIR / "chase.cu").write_text(CHASE_CU)
    chase = subprocess.Popen([cuda._nvcc(), *cuda.NVCC_FLAGS, "-shared", "-o",
                              str(CHASE_DIR / "chase.so"), str(CHASE_DIR / "chase.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        path = cuda.build(verbose=True)
        cuda.library()
    finally:
        _, err = chase.communicate()
    if chase.returncode != 0:
        raise RuntimeError(f"nvcc failed for the pointer chase:\n{err}")
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")


def phase_kernels(left_rgb: torch.Tensor, right_rgb: torch.Tensor, l2: dict | None,
                  tag: str = "", scale: int = SCALE) -> dict:
    """cost_volume and pm_match against their plain twins on identical
    inputs at the shapes of the path at internal scale ``scale``, then their
    device time (profiler and graph replay), their call time and their
    twins'. The images may be a batch of cameras, (B, H, W, 3): tag names
    it in the printed lines. With l2 None the twins are checked and nothing
    is timed (no rows are returned)."""
    dev = left_rgb.device
    iml, imr = to_grayscale(left_rgb), to_grayscale(right_rgb)
    for _ in range(scale.bit_length() - 1):
        iml, imr = pyr_down(iml), pyr_down(imr)
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    D = MAX_DISP // scale
    p = pm.PatchMatchParams(max_disp=D, right_wta=True, volume_bf16=True)
    a, b = float(np.float32(p.alpha)), float(np.float32(1.0 - p.alpha))
    rows = {}

    C = cuda.cost_volume(iml, imr, gl, gr, D, a, b, torch.bfloat16)
    C_plain = cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.bfloat16)
    require_equal(f"cost_volume{tag}", C, C_plain)
    C32 = cuda.cost_volume(iml, imr, gl, gr, D, a, b, torch.float32)
    require_equal(f"cost_volume{tag} float32", C32,
                  cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.float32))
    seed = pm.sparse_wta_seed(C, p)
    noise = pm.unit_noise(iml.shape[-2:], p.noise_seed, device=dev)
    vols = {torch.float32: C32, torch.bfloat16: C}

    def match(vol, s, n):
        return pm._match_one_side(vol, s, n, p)

    if l2 is None:
        print(f"[cost_volume{tag}] images {tuple(iml.shape)}, volume {tuple(C.shape)}: "
              f"bit-identical to the plain twin in bf16 and float32")
        check_match("pm_match", vols, seed, noise, p, match, lambda vol: (vol, vol), None, tag)
        return {}
    rows["cost_volume"] = dict(
        max_abs_err=max_abs(C, C_plain),
        **summarize([measure(
            "cost_volume", lambda: cuda.cost_volume(iml, imr, gl, gr, D, a, b, torch.bfloat16),
            lambda: cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.bfloat16))]),
        **bound(4 * iml.numel() * 4 + C.numel() * C.element_size()),
    )
    rows["pm_match"] = check_match("pm_match", vols, seed, noise, p, match, lambda vol: (vol, vol),
                                   match_bound(C, C, seed, noise, p, 4, l2), tag)
    return rows


def check_match(name, vols, seed, noise, p, kernel, plain_volumes, bounds, tag="") -> dict:
    """A match kernel, kernel(vol, seed, noise), against the plain twin
    _match_plain(*plain_volumes(vol), ...) on each volume of vols ({dtype:
    volume or layouts}), on the path's seed and noise and on an adversarial
    seed: bit-identical, the mask zeroing some pixels and keeping others.
    Then, unless bounds is None, its times on the last (bf16, the
    production dtype) with the path's seed."""
    err, pr = 0.0, p.patch_radius
    adversarial = adversarial_seed(tuple(seed.shape), p.max_disp, seed.device)
    for dtype, vol in vols.items():
        for seeds, (s, n) in (("the path's", (seed, noise)), ("an adversarial", adversarial)):
            got = kernel(vol, s, n)
            want = pm._match_plain(*plain_volumes(vol), s, n, p)
            require_equal(f"{name}{tag} {dtype} {seeds}", got, want)
            err = max(err, max_abs(got, want))
            # Interior pixels the mask zeroed, of those the passes left nonzero.
            pre = pm._match_passes(*plain_volumes(vol), s, n, p)[0][..., pr:-pr, pr:-pr]
            masked = int(((pre > 0) & (want[..., pr:-pr, pr:-pr] == 0)).sum())
            kept = float((got > 0).float().mean())
            if not (masked > 0 and kept > 0):
                raise AssertionError(f"{name}{tag} {dtype}, {seeds} seed: the mask zeroed "
                                     f"{masked} pixels, {kept} of pixels kept")
            print(f"[{name}{tag}] {dtype}, {seeds} seed: bit-identical to the plain twin, "
                  f"{kept:.4f} of pixels kept, {masked} zeroed by the mask")
    if bounds is None:
        return dict(max_abs_err=err)
    row = dict(max_abs_err=err, **summarize([measure(
        name, lambda: kernel(vol, seed, noise),
        lambda: pm._match_plain(*plain_volumes(vol), seed, noise, p), 5)]), **bounds)
    print(f"[{name}{tag}] {times_line(row)}; bound {row['bound_ms']:.5f} ms ({row['bound_by']}; "
          f"{row['volume_elements']} volume elements), chain of {row['chain_trips']} dependent L2 "
          f"round trips ({row['chain_ms']:.5f} ms at the chase's latency)")
    return row


def accuracy(disp: torch.Tensor) -> tuple[float, float]:
    """Median |disparity - TRUE_DISP| over valid pixels, and the valid fraction."""
    valid = disp > 0
    if not valid.any():
        raise AssertionError("no valid disparity")
    return float((disp[valid] - TRUE_DISP).abs().median()), float(valid.float().mean())


def phase_end_to_end(left_rgb, right_rgb, rig, config, tag="e2e",
                     per_frame=PER_FRAME) -> tuple[dict, torch.Tensor, list]:
    """N_RUNS runs of N_FRAMES perturbed frames through perception_step;
    checks launches, finiteness, accuracy and that a frame makes no host
    sync; returns the last run's launch counts, frame 0's disparity and the
    runs' ms/frame."""
    dev = left_rgb.device
    frames = [left_rgb + float(i) * 1e-6 for i in range(N_FRAMES)]
    perception_step(frames[0], right_rgb, rig, config, device=dev)  # warm-up
    torch.cuda.synchronize()

    runs = []
    for _ in range(N_RUNS):
        cuda.reset_launches()
        digest = torch.zeros((), device=dev, dtype=torch.float64)
        outs = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for f in frames:
            out = perception_step(f, right_rgb, rig, config, device=dev)
            # Consume every output, so no stage's work can be skipped.
            digest += out.disparity.sum() + out.depth.sum() + out.enhanced_left.sum()
            outs.append(out)
        end.record()
        end.synchronize()
        launches = dict(cuda.LAUNCHES)
        runs.append(start.elapsed_time(end) / N_FRAMES)
        require_launches(tag, launches, per_frame, N_FRAMES)

    check_fits(tag, record_fit_calls(
        lambda: [perception_step(f, right_rgb, rig, config, device=dev) for f in frames]))
    for i, out in enumerate(outs):
        for field, t in out._asdict().items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"frame {i}: non-finite {field}")
        if out.disparity.shape != (H, W) or out.enhanced_left.shape != (H, W, 3):
            raise AssertionError(f"frame {i}: bad output shapes")
    disp = outs[0].disparity
    med, frac = accuracy(disp)
    if not med < 1.0:
        raise AssertionError(f"median |disp - {TRUE_DISP}| = {med} px over valid pixels")
    if not frac > 0.5:
        raise AssertionError(f"valid fraction {frac}")
    print(f"[{tag}] {N_RUNS} runs of {N_FRAMES} frames: "
          f"{', '.join(f'{ms:.3f}' for ms in runs)} ms/frame "
          f"({1000.0 / statistics.median(runs):.1f} fps at the median), "
          f"median |disp - {TRUE_DISP}| {med:.4f} px, valid {frac:.4f}, digest {float(digest):.6e}, "
          f"launches {launches}")
    sites = sync_sites(lambda: perception_step(frames[0], right_rgb, rig, config, device=dev))
    torch.cuda.synchronize()
    print_syncs(tag, sites)
    if sites:
        raise AssertionError(f"{tag}: perception_step made {len(sites)} host syncs")
    return launches, disp, runs


def phase_graph(left_rgb, right_rgb, rig, config, disp, call_runs, match: tuple | None,
                tag="graph") -> float:
    """perception_step captured whole in one CUDA graph, then replayed over
    N_FRAMES perturbed frames copied into its input, every output consumed
    as in phase_end_to_end; frame 0's replayed disparity must equal the call
    path's bit for bit. Prints the match's share of the replayed frame
    (match: its launch name and graph-replay ms). Returns the replay's
    ms/frame."""
    dev = left_rgb.device
    frames = [left_rgb + float(i) * 1e-6 for i in range(N_FRAMES)]
    static_left = frames[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        perception_step(static_left, right_rgb, rig, config, device=dev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = perception_step(static_left, right_rgb, rig, config, device=dev)
    graph.replay()
    digest = torch.zeros((), device=dev, dtype=torch.float64)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for f in frames:
        static_left.copy_(f)
        graph.replay()
        digest += out.disparity.sum() + out.depth.sum() + out.enhanced_left.sum()
    end.record()
    end.synchronize()
    ms_frame = start.elapsed_time(end) / N_FRAMES
    static_left.copy_(frames[0])
    graph.replay()
    require_equal(f"{tag}: replayed disparity vs the call path's", out.disparity, disp)
    if not torch.isfinite(out.enhanced_left).all() or not torch.isfinite(out.depth).all():
        raise AssertionError(f"{tag}: non-finite replayed outputs")
    share = "" if match is None else (
        f"; the match ({match[0]}, {1e3 * match[1]:.2f} us by graph replay) "
        f"{100.0 * match[1] / ms_frame:.2f}% of the frame")
    print(f"[{tag}] one CUDA graph a frame, {N_FRAMES} frames: {ms_frame:.3f} ms/frame "
          f"({1000.0 / ms_frame:.1f} frames a second) against "
          f"{statistics.median(call_runs):.3f} ms/frame by calls (median of {len(call_runs)} "
          f"runs); digest {float(digest):.6e}; frame 0's disparity equal to the call "
          f"path's{share}")
    return ms_frame


def phase_stage_times(left_rgb, right_rgb, rig, config) -> None:
    """Call time of each stage of perception_step, one frame at a time (the
    host's enqueue included: most stages are bound by it)."""
    from ocean_perception_tpu_torch.imaging.enhance import enhance_underwater
    from ocean_perception_tpu_torch.stereo.cost import cost_volume, subpixel_refine

    p = pm.PatchMatchParams(max_disp=MAX_DISP // SCALE, right_wta=True, volume_bf16=True)
    st = {}
    st["gray+pyr_down"] = call_ms(lambda: (pyr_down(to_grayscale(left_rgb)), pyr_down(to_grayscale(right_rgb))))
    iml, imr = pyr_down(to_grayscale(left_rgb)), pyr_down(to_grayscale(right_rgb))
    st["sobel"] = call_ms(lambda: (gradient_magnitude(iml), gradient_magnitude(imr)))
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    st["cost_volume"] = call_ms(lambda: cost_volume(iml, imr, p.max_disp, p.alpha, gl, gr, torch.bfloat16))
    C = cost_volume(iml, imr, p.max_disp, p.alpha, gl, gr, torch.bfloat16)
    st["noise"] = call_ms(lambda: pm.unit_noise(iml.shape, p.noise_seed, device=iml.device))
    noise = pm.unit_noise(iml.shape, p.noise_seed, device=iml.device)
    st["sparse_wta_seed"] = call_ms(lambda: pm.sparse_wta_seed(C, p))
    seed = pm.sparse_wta_seed(C, p)
    st["patchmatch"] = call_ms(lambda: pm._match_one_side(C, seed, noise, p))
    disp_l = pm._match_one_side(C, seed, noise, p)

    def post():
        disp_r = pm.right_wta_from_left(C, p)
        int_l = torch.round(disp_l).clamp(0, p.max_disp - 1).long()
        d = torch.where(disp_l > 0, subpixel_refine(C, int_l), 0.0)
        d = pm.mask_occlusions(d, disp_r, p)
        d = resize(d, (H, W), method="nearest") * float(SCALE)
        z = rig.disp_to_depth(d)
        return torch.where(torch.isfinite(z) & (z <= config.max_depth), z, 0.0)

    st["right_wta+subpixel+occlusion+depth"] = call_ms(post)
    depth = post()
    st["enhance"] = call_ms(lambda: enhance_underwater(left_rgb, depth, config.enhance), 10)
    total = sum(st.values())
    for k, v in st.items():
        print(f"[stages] {k}: {v:.4f} ms ({100.0 * v / total:.1f}%)")
    print(f"[stages] sum {total:.4f} ms")


def phase_cpu_parity(left_rgb, right_rgb, rig, config, disp_gpu: torch.Tensor) -> None:
    t0 = time.perf_counter()
    disp_cpu = perception_step(left_rgb.cpu(), right_rgb.cpu(), rig, config, device="cpu").disparity
    diff = (disp_gpu.cpu() - disp_cpu).abs()
    close = float((diff <= 1e-3).float().mean())
    med = float(diff.median())
    print(f"[cpu] one frame on the CPU in {time.perf_counter() - t0:.1f} s: "
          f"{100 * close:.3f}% of pixels within 1e-3 px, median |diff| {med}, max {float(diff.max())}")
    if close < 0.99 or med != 0.0:
        raise AssertionError("card and CPU disparities disagree")


def phase_strip_kernels(left_rgb: torch.Tensor, right_rgb: torch.Tensor, l2: dict,
                        tag: str = "strips") -> dict:
    """build_volumes (bf16 and float32) and pm_match_strip against their
    plain twins on identical inputs at 720p shapes, the match also against
    the (H, W, D) match. The images may be a batch of cameras, as in
    phase_kernels."""
    dev = left_rgb.device
    iml = pyr_down(to_grayscale(left_rgb))
    imr = pyr_down(to_grayscale(right_rgb))
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    D = MAX_DISP // SCALE
    Hs, Ws = iml.shape[-2:]
    p = pm.PatchMatchParams(max_disp=D, right_wta=True, volume_bf16=True, use_strip_volumes=True)
    g = sc.strip_geometry(Hs, Ws, D, p.chunks, p.chunks_y)
    a, b = float(np.float32(p.alpha)), float(np.float32(1.0 - p.alpha))
    print(f"[{tag}] images {tuple(iml.shape)}: V_row {(g.chunk_x, g.chunks_x, D, Hs)}, V_col "
          f"{(g.chunk_y, g.chunks_y, D, Ws)} a camera")
    rows = {}

    vols = {}
    for dtype in (torch.float32, torch.bfloat16):  # bf16, the production dtype, last
        def kernel():
            return cuda.build_volumes(iml, imr, gl, gr, D, a, b, g.chunks_x, g.chunks_y, dtype)

        def plain():
            return sc.build_strip_volumes_plain(iml, imr, gl, gr, D, p.alpha, p.chunks, p.chunks_y,
                                                dtype)

        (vr, vc), (vr_p, vc_p) = kernel(), plain()
        require_equal(f"build_volumes V_row {dtype}", vr, vr_p)
        require_equal(f"build_volumes V_col {dtype}", vc, vc_p)
        vols[dtype] = vr, vc
        rows["build_volumes"] = dict(
            max_abs_err=max(max_abs(vr, vr_p), max_abs(vc, vc_p)),
            **summarize([measure("build_volumes", kernel, plain)]),
            **bound(4 * iml.numel() * 4 + (vr.numel() + vc.numel()) * vr.element_size()))
        print(f"[{tag}] build_volumes {dtype}: {times_line(rows['build_volumes'])}; bound "
              f"{rows['build_volumes']['bound_ms']:.4f} ms")
    C = sc.volume_from_col_strips(vc)
    seed = pm.sparse_wta_seed(C, p)
    noise = pm.unit_noise(iml.shape[-2:], p.noise_seed, device=dev)

    def plain_volumes(v):
        return sc.volume_from_row_strips(v[0]), sc.volume_from_col_strips(v[1])

    rows["pm_match_strip"] = check_match(
        "pm_match_strip", vols, seed, noise, p,
        lambda v, s, n: pm._match_one_side_strips(*v, s, n, p), plain_volumes,
        match_bound(*plain_volumes(vols[torch.bfloat16]), seed, noise, p, 1, l2),
        "" if tag == "strips" else f" {tag}")
    full = pm._match_one_side_strips(vr, vc, seed, noise, p)
    require_equal("pm_match_strip vs the (H, W, D) match", full,
                  pm._match_one_side(C, seed, noise, p))
    hwd_ms = call_ms(lambda: pm._match_one_side(C, seed, noise, p))
    hwd_dev = graph_ms(lambda: pm._match_one_side(C, seed, noise, p))
    print(f"[{tag}] pm_match_strip: call {rows['pm_match_strip']['call_ms']:.4f} ms vs the (H, W, "
          f"D) match's {hwd_ms:.4f} ms; device (graph replay) "
          f"{rows['pm_match_strip']['graph_ms']:.4f} vs {hwd_dev:.4f} ms; equal to it, "
          f"valid {(full > 0).float().mean().item():.3f}")
    # The dense half on each layout, in turns (H, W, D), strips, strips,
    # (H, W, D): the volume build, seed, match, right WTA and subpixel.
    p_hwd = dataclasses.replace(p, use_strip_volumes=False)
    turns = [call_ms(lambda q=q: pm.patchmatch_disparity(iml, imr, q), 10)
             for q in (p_hwd, p, p, p_hwd)]
    print(f"[{tag}] patchmatch_disparity at {Hs}x{Ws}, in turns: (H, W, D) {turns[0]:.4f}, "
          f"strips {turns[1]:.4f}, strips {turns[2]:.4f}, (H, W, D) {turns[3]:.4f} ms")
    for name, row in rows.items():
        print(f"[{tag}] {name}: {times_line(row)}; bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}), max |diff| {row['max_abs_err']}")
    return rows


def dense_disparity(left_rgb, right_rgb, params: pm.PatchMatchParams, device) -> torch.Tensor:
    """The dense half of perception_step with another PatchMatch
    configuration: grays at half resolution, estimate_disparity, then the
    step's nearest upsampling and doubling."""
    left_rgb = torch.as_tensor(left_rgb, dtype=torch.float32, device=device)
    right_rgb = torch.as_tensor(right_rgb, dtype=torch.float32, device=device)
    gray_l = pyr_down(to_grayscale(left_rgb))
    gray_r = pyr_down(to_grayscale(right_rgb))
    r = estimate_disparity(gray_l, gray_r, engine="patchmatch", patchmatch_params=params)
    return resize(r.left, (H, W), method="nearest") * float(SCALE)


def phase_engines(left_rgb, right_rgb, rig, canvas) -> dict:
    """The other stereo configurations at 720p: N_ENGINE_FRAMES timed frames
    each after a warm-up, launch counts, accuracy, and one frame against
    the CPU (within 1e-3 px on >= 99% of pixels); then the two PatchMatch
    configurations on N_CAMERAS cameras in one call (phase_engines_batched)."""
    D = MAX_DISP // SCALE
    engines = {
        "sgm": (lambda l, r, dev: perception_step(l, r, rig, PerceptionConfig(
            engine="sgm", max_disp=MAX_DISP, internal_scale=SCALE, run_enhance=False),
            device=dev).disparity, {"cost_volume": 1}),
        "wta": (lambda l, r, dev: perception_step(l, r, rig, PerceptionConfig(
            engine="wta", max_disp=MAX_DISP, internal_scale=SCALE, run_enhance=False),
            device=dev).disparity, {"cost_volume": 1}),
        "patchmatch two-sided": (lambda l, r, dev: dense_disparity(l, r, pm.PatchMatchParams(
            max_disp=D, right_wta=False, volume_bf16=True), dev),
            {"cost_volume": 1, "pm_match": 2}),
        "patchmatch zncc": (lambda l, r, dev: dense_disparity(l, r, pm.PatchMatchParams(
            max_disp=D, right_wta=True, cost="zncc"), dev),
            {"pm_match": 1}),
    }
    dev = left_rgb.device
    results = {}
    for name, (run, per_frame) in engines.items():
        frames = [left_rgb + float(i) * 1e-6 for i in range(N_ENGINE_FRAMES)]
        run(frames[0], right_rgb, dev)  # warm-up
        torch.cuda.synchronize()
        cuda.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        disps = [run(f, right_rgb, dev) for f in frames]
        end.record()
        end.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        require_launches(name, dict(cuda.LAUNCHES), per_frame, N_ENGINE_FRAMES)
        ms_frame = start.elapsed_time(end) / N_ENGINE_FRAMES
        disp = disps[0]
        if disp.shape != (H, W) or not torch.isfinite(disp).all():
            raise AssertionError(f"{name}: bad disparity")
        med, frac = accuracy(disp)
        t0 = time.perf_counter()
        disp_cpu = run(frames[0].cpu(), right_rgb.cpu(), "cpu")
        cpu_s = time.perf_counter() - t0
        close = float(((disp.cpu() - disp_cpu).abs() <= 1e-3).float().mean())
        results[name] = dict(ms_frame=ms_frame, median_err=med, valid=frac, cpu_close=close)
        print(f"[engines] {name}: {ms_frame:.3f} ms/frame over {N_ENGINE_FRAMES} frames, "
              f"median |disp - {TRUE_DISP}| {med:.4f} px, valid {frac:.4f}, launches {launches}; "
              f"CPU frame in {cpu_s:.1f} s, "
              f"{100 * close:.3f}% of pixels within 1e-3 px")
        if not med < 1.0:
            raise AssertionError(f"{name}: median |disp - {TRUE_DISP}| = {med} px")
        if not frac > 0.25:
            raise AssertionError(f"{name}: valid fraction {frac}")
        if close < 0.99:
            raise AssertionError(f"{name}: card and CPU disparities disagree")
    phase_engines_batched({k: engines[k] for k in engines if k.startswith("patchmatch")},
                          canvas, results, dev)
    return results


def phase_engines_batched(engines: dict, canvas, results: dict, dev) -> None:
    """Each engine's dense half on N_CAMERAS cameras in one call, each its
    own frame of the sequence: N_ENGINE_FRAMES timed calls after a warm-up,
    each kernel launched as often a call as a one-camera frame launches it
    (the two-sided match once a side), and each camera's disparity equal to
    its one-camera call's bit for bit."""
    B = N_CAMERAS
    pairs = [make_inputs(canvas, i) for i in range(B)]
    left = torch.as_tensor(np.stack([l for l, _ in pairs]), device=dev)
    right = torch.as_tensor(np.stack([r for _, r in pairs]), device=dev)
    for name, (run, per_frame) in engines.items():
        frames = [left + float(i) * 1e-6 for i in range(N_ENGINE_FRAMES)]
        run(frames[0], right, dev)  # warm-up
        torch.cuda.synchronize()
        cuda.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        disps = [run(f, right, dev) for f in frames]
        end.record()
        end.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        require_launches(f"{name} B={B}", dict(cuda.LAUNCHES), per_frame, N_ENGINE_FRAMES)
        ms_call = start.elapsed_time(end) / N_ENGINE_FRAMES
        if disps[0].shape != (B, H, W) or not torch.isfinite(disps[0]).all():
            raise AssertionError(f"{name} B={B}: bad disparity")
        accs = []
        for b in range(B):
            require_equal(f"{name} B={B} camera {b} vs its one-camera call", disps[0][b],
                          run(frames[0][b], right[b], dev))
            accs.append(accuracy(disps[0][b]))
            if not (accs[-1][0] < 1.0 and accs[-1][1] > 0.25):
                raise AssertionError(f"{name} B={B} camera {b}: median |disp - {TRUE_DISP}| "
                                     f"{accs[-1][0]} px, valid {accs[-1][1]}")
        one = results[name]["ms_frame"]
        results[name]["batched"] = dict(cameras=B, ms_call=ms_call)
        print(f"[engines B={B}] {name}: {ms_call:.3f} ms a call of {B} cameras over "
              f"{N_ENGINE_FRAMES} calls ({B * 1000.0 / ms_call:.1f} camera frames a second) "
              f"against {one:.3f} ms/frame for one camera ({ms_call / (B * one):.3f} of {B} "
              f"one-camera frames); each camera's disparity equal to its one-camera call's; "
              f"median |disp - {TRUE_DISP}| "
              + ", ".join(f"{m:.4f}" for m, _ in accs) + " px, valid "
              + ", ".join(f"{v:.4f}" for _, v in accs) + f"; launches {launches}")


def lk_bounds(call, steps: list, boxes: list) -> dict:
    """Bound of one lk_track launch (one direction, every level), from its
    recorded arguments and the steps each point took on each level (steps:
    (level, (K,) steps) from lk_track_plain; boxes: (level, (K, 2) rows and
    columns of the box covering every window the unbounded walk read), from
    it too). Bytes: each point's template
    and slack windows a level read, its point, guess and frame indices read,
    its point and status written. Operations (a multiply-add counted as
    two): the two-tap recentring, the gradients, the 5 window sums, the
    2*A*A surface sums of win^2 multiply-adds, and the walk's steps. Its
    chain of dependent operations: the coarsest level's window sums (row,
    then column), then on every level the win^2-long sum of a surface value
    and the most steps any point took times LK_STEP_CHAIN; the levels follow
    one another, since each slack window sits at the coarser level's guess.

    The unbounded walk (slack <= 0) has no slack window and no surfaces:
    each point's search bytes a level are its box, read once (the walk
    moves less than a pixel a step, and its windows overlap); a step
    resamples, differences and sums a win^2 patch (LK_UNBOUNDED_LINE_OPS a
    patch row and column, LK_UNBOUNDED_ELEMENT_OPS a patch element, 50 a
    step); its chain is a step's two win-long sums and LK_STEP_CHAIN, times
    the most steps any point took."""
    (tmpl_levels, _, points, *_), kwargs = call[1], call[2]
    # Points of every camera of a batch.
    K, slack, wins = points.shape[:-1].numel(), kwargs["slack"], kwargs["wins"]
    taken, read = dict(steps), dict(boxes)
    nbytes, flops, chain = K * (4 * 2 * 2 + 4 * 2 + 4 * 2 + 1), 0, 0
    for lvl in range(len(tmpl_levels) - 1, -1, -1):
        win = wins[lvl]
        if win is None:
            continue
        ST, P, ws = win + 3, win + 2, win + 2 * (slack + 1)
        A = ws - win + 1
        tmpl_flops = 3 * P * ST + 3 * P * P + 4 * win * win + 5 * 2 * win * win
        if slack <= 0:
            n_steps = int(taken[lvl].sum())
            nbytes += K * 4 * ST * ST + 4 * int(read[lvl].long().prod(-1).sum())
            flops += K * (tmpl_flops + 20) + n_steps * (
                LK_UNBOUNDED_LINE_OPS * 2 * win + LK_UNBOUNDED_ELEMENT_OPS * win * win + 50)
            chain += (2 * win if chain == 0 else 0)
            chain += int(taken[lvl].max()) * (2 * win + LK_STEP_CHAIN)
            continue
        nbytes += K * 4 * (ST * ST + ws * ws)
        flops += K * (tmpl_flops + 2 * A * A * 2 * win * win + 20)
        flops += int(taken[lvl].sum()) * 50  # a step's tents, lookups, solve and test
        chain += (2 * win if chain == 0 else 0) + win * win
        chain += int(taken[lvl].max()) * LK_STEP_CHAIN
    return dict(**bound(nbytes, flops), chain_ops=chain,
                chain_ms=1e3 * chain * OP_CYCLES / CLOCK_HZ)


def coarse_bounds(call) -> dict:
    """Bound of one lk_coarse_match launch, from its recorded arguments.
    Bytes: each point's template and search window read, its point and
    frame index read, its match written. Operations: a subtraction, a
    product and a sum for each template pixel at each offset. Its chain: a
    thread's offsets (one after another) of patch^2 dependent sums, then the
    block's least (5 shuffle steps and the warps')."""
    (_, _, points, _), kwargs = call[1], call[2]
    K, s, p = points.shape[:-1].numel(), kwargs["search"], kwargs["patch"]
    n, wn = 2 * s + 1, p + 2 * s
    nbytes = K * (4 * (p * p + wn * wn) + 4 * 2 + 4 + 4 * 2)
    flops = K * n * n * p * p * 3
    chain = -(-n * n // 128) * p * p + 5 + 4
    return dict(**bound(nbytes, flops), chain_ops=chain,
                chain_ms=1e3 * chain * OP_CYCLES / CLOCK_HZ)


def record_lk_calls(fn) -> list:
    """Run fn() and return, for every lk_track and coarse_block_match call
    it made in order, (name, args, kwargs, launch): the dispatcher's
    arguments, the exact inputs the main path gives the kernel, for the
    plain twin; and the arguments the dispatcher handed the kernel's wrapper
    (lk_track's, lk_coarse_match's), to time the kernel alone."""
    calls, launches = [], []
    spied = (("lk_track", "lk_track", "lk_track"),
             ("lk_coarse_match", "coarse_block_match", "lk_coarse_match"))
    saved = [(getattr(lk, fn_name), getattr(cuda, wrapper_name))
             for _, fn_name, wrapper_name in spied]

    def spy(name, orig):
        def call(*args, **kwargs):
            calls.append((name, args, kwargs))
            return orig(*args, **kwargs)
        return call

    def spy_wrapper(name, wrapper):
        def launch(*args):
            launches.append((name, args))
            return wrapper(*args)
        return launch

    try:
        for (name, fn_name, wrapper_name), (orig, wrapper) in zip(spied, saved):
            setattr(lk, fn_name, spy(name, orig))
            setattr(cuda, wrapper_name, spy_wrapper(name, wrapper))
        fn()
    finally:
        for (_, fn_name, wrapper_name), (orig, wrapper) in zip(spied, saved):
            setattr(lk, fn_name, orig)
            setattr(cuda, wrapper_name, wrapper)
    if [c[0] for c in calls] != [name for name, _ in launches]:
        raise AssertionError(f"LK calls {[c[0] for c in calls]} launched "
                             f"{[name for name, _ in launches]}")
    return [(*call, launch) for call, (_, launch) in zip(calls, launches)]


def folded(launch: tuple) -> tuple:
    """lk_track's wrapper arguments with a batch of cameras folded into the
    rings, as the wrapper folds them (ops/windows.py::fold_rings): the same
    launch, without the few small kernels that fold the frame indices, so
    that a timing window holds the LK kernel alone."""
    tmpl, srch, pts, init, src_t, src_s, *rest = launch
    batch = tuple(pts.shape[:-2])
    if not batch:
        return launch
    K = pts.shape[-2]
    tmpl, src_t = fold_rings(tmpl, src_t, batch, K)
    srch, src_s = fold_rings(srch, src_s, batch, K)
    return (tmpl, srch, pts.reshape(-1, 2), init.reshape(-1, 2), src_t, src_s, *rest)


def phase_lk_kernels(calls: list, tag: str = "lk") -> dict:
    """lk_track against its twin on one frontend frame's recorded inputs (4
    levels, forward then backward; one camera, or a batch of them in one
    launch): bit-identical; then each direction's times, bound and chain,
    and the Gauss-Newton steps the points took on each level (from the
    twin)."""
    calls = [c for c in calls if c[0] == "lk_track"]
    if len(calls) != 2:
        raise AssertionError(f"expected a forward and a backward lk_track, got {len(calls)}")
    err, times, bounds = 0.0, [], []
    for direction, (name, args, kwargs, launch) in zip(("forward", "backward"), calls):
        got = lk.lk_track(*args, **kwargs)
        steps, boxes = [], []
        want = lk.lk_track_plain(*args, **kwargs, steps=steps, boxes=boxes)
        for a, b in zip(got, want):
            fa, fb = a.float().nan_to_num(-1e30), b.float().nan_to_num(-1e30)
            require_equal(f"lk_track {direction}", fa, fb)
            err = max(err, max_abs(fa, fb))
        for lvl, moved in steps:
            print(f"[{tag}] {direction} level {lvl} (window {kwargs['wins'][lvl]}): Gauss-Newton "
                  f"steps mean {moved.float().mean().item():.3f}, max {int(moved.max())} "
                  f"over {moved.numel()} points")
        flat = folded(launch)
        times.append(measure("lk_track", lambda: cuda.lk_track(*flat),
                             lambda: lk.lk_track_plain(*args, **kwargs), 5))
        bounds.append(lk_bounds((name, args, kwargs), steps, boxes))
        b = bounds[-1]
        print(f"[{tag}] lk_track {direction} ({len(args[0])} levels, points "
              f"{tuple(args[2].shape[:-1])}): "
              f"{times_line(times[-1])}; bound {b['bound_ms']:.5f} ms ({b['bound_by']}), chain of "
              f"{b['chain_ops']} dependent operations ({b['chain_ms']:.5f} ms at {OP_CYCLES} "
              f"cycles an operation, {CLOCK_HZ / 1e9:.2f} GHz)")
    row = dict(max_abs_err=err, **summarize(times),
               bound_ms=statistics.mean(b["bound_ms"] for b in bounds),
               bound_by=bounds[0]["bound_by"],
               chain_ops=statistics.mean(b["chain_ops"] for b in bounds),
               chain_ms=statistics.mean(b["chain_ms"] for b in bounds))
    print(f"[{tag}] lk_track, a launch (mean of the 2): {times_line(row)}; bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}), chain {row['chain_ms']:.5f} ms, "
          f"max |diff| {row['max_abs_err']}; a frame's LK: 2 launches, "
          f"{2 * row['device_ms'] * 1e3:.3f} us of device time")
    return {"lk_track": row}


def sync_sites(fn) -> list:
    """One entry per host sync made by fn(), as torch.cuda.set_sync_debug_mode
    reports it: the port's frames of the Python stack at the sync, innermost
    first."""
    sites = []

    def record(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            stack = traceback.extract_stack()[:-1]
            # The port's frames, or else the innermost three of any file.
            frames = [f for f in stack if "ocean_perception_tpu_torch" in f.filename] or stack[-3:]
            sites.append(" <- ".join(f"{Path(f.filename).name}:{f.lineno}" for f in frames[::-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def print_syncs(tag: str, sites: list) -> None:
    print(f"[{tag}] host syncs per frame: {len(sites)}")
    for site, n in sorted({s: sites.count(s) for s in sites}.items()):
        print(f"[{tag}]   {n} x {site}")


def track_error(a, c, shift: int) -> torch.Tensor:
    """|x| and |y| error of every slot that one frontend frame tracked from
    track table a to track table c, on a sequence whose features move -shift
    px a frame (a slot missed m frames has moved (m + 1) * shift)."""
    same = (a.ids >= 0) & (a.ids == c.ids) & (c.missed == 0)
    moved = c.pixels[same] - a.pixels[same]
    moved[:, 0] += shift * (a.missed[same].float() + 1)
    return moved.abs().flatten()


def phase_frontend(canvas, rig, config, dev, params=None, shift: int = SHIFT,
                   per_frame: dict = PER_FRONTEND_FRAME, tag: str = "frontend") -> dict:
    """full_frontend_step over the moving sequence (features move -shift px a
    frame): 4 warm-up frames fill the ring (frame 0 is the first keyframe),
    frame 4 is recorded for the LK kernel check, frames 5..12 are timed and
    checked (launches per_frame a frame)."""
    params = params or ObjectMesherDeviceParams()
    frames = [tuple(torch.as_tensor(a, device=dev) for a in make_inputs(canvas, i, shift))
              for i in range(5 + N_FRAMES + 1)]
    state = StereoTrackerState.create(params.tracker, image_shape=(H, W), device=dev)
    graph = LandmarkGraph.create(params.tracker.capacity, device=dev)
    prev = to_grayscale(frames[0][0])

    def step(i):
        nonlocal state, graph, prev
        out, prev = full_frontend_step(state, graph, prev, *frames[i], rig, config, params,
                                       device=dev)
        state, graph = out.tracker_state, out.graph
        return out

    for i in range(4):
        out = step(i)
        if i == 0:
            alive = int(out.tracker_state.table.alive.sum())
            if not (bool(out.mesher.is_keyframe) and alive >= 50):
                raise AssertionError(f"{tag} first keyframe: {alive} landmarks alive")
    calls = record_lk_calls(lambda: step(4))
    torch.cuda.synchronize()

    cuda.reset_launches()
    start_state = (state, graph, prev)
    before, outs = [state], []
    digest = torch.zeros((), device=dev, dtype=torch.float64)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(5, 5 + N_FRAMES):
        out = step(i)
        # Consume every stage's output, labels and sizes included, so that no
        # stage's work can be skipped.
        m = out.mesher
        digest += (out.perception.disparity.sum() + out.perception.enhanced_left.sum()
                   + m.disparities.sum() + m.labels.sum() + m.sizes.sum())
        outs.append(out)
        before.append(state)
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) / N_FRAMES
    launches = dict(cuda.LAUNCHES)
    ms_frame = start.elapsed_time(end) / N_FRAMES

    require_launches(tag, launches, per_frame, N_FRAMES)
    errs, disps = [], []
    for k, out in enumerate(outs):
        for field, t in (*out.perception._asdict().items(),
                         *((f, v) for f, v in out.mesher._asdict().items() if v.is_floating_point())):
            if not torch.isfinite(t).all():
                raise AssertionError(f"{tag} frame {k}: non-finite {field}")
        errs.append(track_error(before[k].table, before[k + 1].table, shift))
        d = out.mesher.disparities[out.tracker_state.table.alive]
        disps.append(d[d > 0] - TRUE_DISP)
    errs, disps = torch.cat(errs), torch.cat(disps)
    med_err, med_disp = float(errs.median()), float(disps.abs().median())
    alive = int(outs[-1].tracker_state.table.alive.sum())
    clusters = int((outs[-1].mesher.sizes >= 3).sum())
    print(f"[{tag}] {N_FRAMES} frames: {ms_frame:.3f} ms/frame ({1000.0 / ms_frame:.1f} fps), "
          f"host {1000.0 * wall:.3f} ms/frame, median |track error| {med_err:.5f} px over "
          f"{errs.numel() // 2} tracks, median |stripe disp - {TRUE_DISP}| {med_disp:.4f} px over "
          f"{disps.numel()} matches, {alive} alive, {clusters} clusters of >= 3, "
          f"digest {float(digest):.6e}, launches {launches}")
    if not med_err < 0.1:
        raise AssertionError(f"{tag}: median |track error| {med_err} px")
    if not med_disp < 0.5:
        raise AssertionError(f"{tag}: median |stripe disparity - {TRUE_DISP}| {med_disp} px")
    if alive < 50:
        raise AssertionError(f"{tag}: {alive} landmarks alive")

    sites = sync_sites(lambda: step(5 + N_FRAMES))
    torch.cuda.synchronize()
    print_syncs(tag, sites)
    if len(sites) > FRONTEND_SYNCS:
        raise AssertionError(f"{tag}: {len(sites)} host syncs a frame, more than the "
                             f"{FRONTEND_SYNCS} PERF.md names")
    return dict(launches=launches, calls=calls, ms_frame=ms_frame, frames=frames, params=params,
                state=before[-2], graph=outs[-2].graph, prev=to_grayscale(frames[4 + N_FRAMES - 1][0]),
                out=outs[-1], start=start_state, first=outs[0], med_err=med_err, alive=alive)


def _map_tensors(fn, obj):
    """obj (a dataclass, tuple or tensor, nested) with fn applied to every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map_tensors(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_map_tensors(fn, o) for o in obj)
    raise TypeError(f"not a tensor tree: {type(obj)}")


def _tensors(obj) -> list:
    out = []
    _map_tensors(out.append, obj)
    return out


def camera(obj, b: int):
    """Camera b of a fleet's tensor tree (each tensor's leading axis)."""
    return _map_tensors(lambda t: t[b], obj)


def frontend_graph(step, start, frames, first, last, tag: str) -> float:
    """A frontend call, step(state, graph, prev_gray, left, right) -> (out,
    gray), captured whole in one CUDA graph with static state, graph,
    previous-gray and image inputs, then replayed over frames from the
    state start = (state, graph, prev_gray): after each replay the outputs'
    tracker state, landmark graph and gray image are copied into the static
    inputs, and every output is consumed as in phase_frontend. The first
    and the last replayed frames' labels, slot ids and pixels must equal
    first's and last's, the call path's. Returns the replay's ms/frame."""
    state0, graph0, prev0 = start
    dev = prev0.device
    st, gr, prev = (_map_tensors(torch.clone, x) for x in (state0, graph0, prev0))
    left, right = (t.clone() for t in frames[0])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(st, gr, prev, left, right)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, gray = step(st, gr, prev, left, right)

    def load(state, lmk_graph, prev_gray, frame):
        for dst, src in zip(_tensors((st, gr, prev, left, right)),
                            _tensors((state, lmk_graph, prev_gray, *frame))):
            dst.copy_(src)

    def require_frame(which, call_out):
        for field, a, b in (("labels", out.mesher.labels, call_out.mesher.labels),
                            ("slot ids", out.tracker_state.table.ids, call_out.tracker_state.table.ids),
                            ("pixels", out.tracker_state.table.pixels,
                             call_out.tracker_state.table.pixels)):
            require_equal(f"{tag} {which} {field} vs the call path's", a, b)

    load(state0, graph0, prev0, frames[0])
    graph.replay()
    require_frame("frame 0", first)
    load(state0, graph0, prev0, frames[0])
    digest = torch.zeros((), device=dev, dtype=torch.float64)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i, frame in enumerate(frames):
        if i:
            load(out.tracker_state, out.graph, gray, frame)
        graph.replay()
        m = out.mesher
        digest += (out.perception.disparity.sum() + out.perception.enhanced_left.sum()
                   + m.disparities.sum() + m.labels.sum() + m.sizes.sum())
    t1.record()
    t1.synchronize()
    ms_frame = t0.elapsed_time(t1) / len(frames)
    require_frame(f"frame {len(frames) - 1}", last)
    print(f"[{tag}] one CUDA graph a call, {len(frames)} calls: {ms_frame:.3f} ms a call; digest "
          f"{float(digest):.6e}; the first and last calls' labels, slot ids and pixels equal to "
          f"the call path's")
    return ms_frame


def phase_frontend_graph(fe, rig, config, lk_device_ms: float,
                         tag: str = "frontend graph",
                         lk_launches: str = "2 lk_track launches") -> float:
    """full_frontend_step as one CUDA graph a frame (frontend_graph) over the
    timed frames of phase_frontend, from the same start; prints LK's share
    of the replayed frame, lk_device_ms for the lk_launches of a frame.
    Returns the replay's ms/frame."""
    dev = fe["start"][2].device

    def step(st, gr, prev, left, right):
        return full_frontend_step(st, gr, prev, left, right, rig, config, fe["params"], device=dev)

    ms_frame = frontend_graph(step, fe["start"], fe["frames"][5:5 + N_FRAMES], fe["first"],
                              fe["out"], tag)
    print(f"[{tag}] {ms_frame:.3f} ms/frame ({1000.0 / ms_frame:.1f} fps) against "
          f"{fe['ms_frame']:.3f} ms/frame by calls; LK ({lk_launches}, "
          f"{1e3 * lk_device_ms:.3f} us) {100.0 * lk_device_ms / ms_frame:.2f}% of the frame")
    return ms_frame


def phase_frontend_stage_times(fe, rig, config) -> None:
    """Call time of each stage of one frontend frame (the last timed one)."""
    from ocean_perception_tpu_torch.mesher.foreground import estimate_foreground_mask
    from ocean_perception_tpu_torch.mesher.object_mesher import mesher_device_step
    from ocean_perception_tpu_torch.tracking.detector import detect_features
    from ocean_perception_tpu_torch.tracking.stereo_tracker import track_and_triangulate
    from ocean_perception_tpu_torch.tracking.stripe_match import match_rectified

    p, state, graph, prev = fe["params"], fe["state"], fe["graph"], fe["prev"]
    left, right = fe["frames"][4 + N_FRAMES]
    gl, gr = to_grayscale(left), to_grayscale(right)
    fxb = torch.full((), 700.0 * 0.12, device=left.device)
    table = state.table
    pyr = tuple(image_pyramid(gl, p.tracker.lk.max_level + 1))
    st = {}
    st["frame (full_frontend_step)"] = call_ms(
        lambda: full_frontend_step(state, graph, prev, left, right, rig, config, p,
                                   device=left.device), 5)
    st["perception_step"] = call_ms(lambda: perception_step(left, right, rig, config, left.device), 5)
    st["mesher half (mesher_device_step)"] = call_ms(
        lambda: mesher_device_step(state, graph, prev, gl, gr, fxb, p), 5)
    st["  tracker (track_and_triangulate)"] = call_ms(
        lambda: track_and_triangulate(state, prev, gl, gr, fxb, p.tracker), 5)
    st["    image pyramid"] = call_ms(lambda: image_pyramid(gl, p.tracker.lk.max_level + 1))
    st["    LK, forward + backward (track_points_ring)"] = call_ms(
        lambda: lk.track_points_ring(state.ring, pyr, table.pixels, table.alive, table.missed,
                                     p.tracker.lk), 10)
    st["    detector"] = call_ms(lambda: detect_features(gl, p.tracker.detector, table.pixels,
                                                        table.alive), 10)
    st["    stripe matcher"] = call_ms(lambda: match_rectified(gl, gr, table.pixels, table.alive,
                                                              p.tracker.matcher), 10)
    st["  foreground mask"] = call_ms(lambda: estimate_foreground_mask(
        gl, p.foreground_ksize, p.foreground_min_gradient))
    frame = st["frame (full_frontend_step)"]
    for k, v in st.items():
        print(f"[frontend stages] {k}: {v:.4f} ms ({100.0 * v / frame:.1f}% of the frame)")
    syncs = {
        "perception_step": len(sync_sites(lambda: perception_step(left, right, rig, config,
                                                                  left.device))),
        "tracker": len(sync_sites(lambda: track_and_triangulate(state, prev, gl, gr, fxb,
                                                                p.tracker))),
        "mesher half": len(sync_sites(lambda: mesher_device_step(state, graph, prev, gl, gr, fxb,
                                                                 p))),
    }
    torch.cuda.synchronize()
    print(f"[frontend stages] host syncs: {syncs}")
    print(f"[frontend] tracker share of the frame: "
          f"{100.0 * st['  tracker (track_and_triangulate)'] / frame:.1f}%")


def phase_frontend_cpu_parity(fe, rig, config) -> None:
    """The last timed frontend frame again on the CPU, from the same state."""
    cpu = torch.device("cpu")
    state, graph, prev = fe["state"].to(cpu), fe["graph"].to(cpu), fe["prev"].cpu()
    left, right = (t.cpu() for t in fe["frames"][4 + N_FRAMES])
    t0 = time.perf_counter()
    out, _ = full_frontend_step(state, graph, prev, left, right, rig, config, fe["params"],
                                device=cpu)
    took = time.perf_counter() - t0
    g, c = fe["out"], out
    gt, ct = g.tracker_state.table, c.tracker_state.table
    alive_agree = float((g.mesher.alive.cpu() == c.mesher.alive).float().mean())
    both = ((gt.ids.cpu() == ct.ids) & (gt.ids.cpu() >= 0) & (gt.missed.cpu() == 0)
            & (ct.missed == 0))
    px = float((gt.pixels.cpu() - ct.pixels)[both].abs().max()) if both.any() else 0.0
    labels_equal = torch.equal(g.mesher.labels.cpu(), c.mesher.labels)
    print(f"[frontend cpu] one frame on the CPU in {took:.1f} s: alive slots agree on "
          f"{100 * alive_agree:.2f}%, max |pixel diff| {px} over {int(both.sum())} tracks, "
          f"labels equal {labels_equal}")
    if alive_agree < 0.99 or not px <= 1e-3 or not labels_equal:
        raise AssertionError("card and CPU frontends disagree")


def kernel_count(fn, n: int = 2) -> dict:
    """CUDA kernels one call of fn() runs, by name: those ``torch.profiler``
    recorded over n calls (memory copies and sets not counted), over n."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count / n for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))}


def count_changes(one: dict, many: dict, top: int = 8) -> str:
    """The kernels whose count a call differs between two kernel_count
    readings, the largest differences first."""
    diff = {k: many.get(k, 0.0) - one.get(k, 0.0) for k in one.keys() | many.keys()}
    diff = sorted(((d, k) for k, d in diff.items() if d), key=lambda t: -abs(t[0]))
    return "; ".join(f"{d:+g} {k[:90]}" for d, k in diff[:top]) or "none"


def graph_kernel_nodes(fn) -> int | None:
    """Kernel nodes of one call of fn() captured in a CUDA graph, as
    libcuda's cuGraphGetNodes and cuGraphNodeGetType list them; None where
    this torch cannot keep the captured graph."""
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    drv.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    drv.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if drv.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if drv.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        if drv.cuGraphNodeGetType(node, ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def peak_bytes(fn) -> tuple[int, int]:
    """torch.cuda.max_memory_allocated over one call of fn(), and the part
    of it above what was allocated before the call (the call's own)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - before


def record_lm_calls(fn) -> dict:
    """Run fn() and return the arguments of every lm_solve_small and
    lm_row_sum launch it made, cloned, by launch name."""
    calls = {"lm_solve_small": [], "lm_row_sum": []}
    wrappers = {name: getattr(cuda, name) for name in calls}

    def spy(name):
        def launch(*args):
            calls[name].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return wrappers[name](*args)
        return launch

    try:
        for name in calls:
            setattr(cuda, name, spy(name))
        fn()
    finally:
        for name, wrapper in wrappers.items():
            setattr(cuda, name, wrapper)
    return calls


def lm_bound(name: str, args: tuple) -> dict:
    """Bound of one launch: its inputs read and outputs written once, and
    its operations (a multiply and an add each counted) at the rate of their
    type: for lm_solve_small the P(P+1)/2 + P dot products of N terms, the
    damping, the elimination and the back substitution; for lm_row_sum
    N - 1 adds a row."""
    size = args[0].element_size()
    peak = PEAK_F64_PER_S if args[0].dtype == torch.float64 else PEAK_F32_PER_S
    if name == "lm_row_sum":
        (x,) = args
        rows, n = x.numel() // x.shape[-1], x.shape[-1]
        return bound(size * (x.numel() + rows), rows * (n - 1), peak)
    J, r, lam, _ = args
    N, P = J.shape[-2], J.shape[-1]
    M = J.numel() // (N * P)
    ops = (2 * N * (P * (P + 1) // 2 + P) + 2 * P * P
           + sum((P - k - 1) * (3 + 2 * (P - k - 1)) for k in range(P)) + P * P)
    return bound(size * (J.numel() + r.numel() + lam.numel() + M * P), M * ops, peak)


def lm_chain(N: int, P: int) -> dict:
    """The longest chain of dependent operations of one system of
    lm_solve_small, each taken at OP_CYCLES: a product and the tree's
    log2(Np) levels of sums, the damping's product and sum, then for each
    elimination step k its pivot, a comparison tree over the P - k
    candidate rows, and (but for the last) its quotient, product and
    difference, and the back substitution's P quotients, each but the last
    followed by a product and a difference."""
    levels = max(N - 1, 0).bit_length()
    pivots = sum((P - k - 1).bit_length() for k in range(P))
    ops = 1 + levels + 2 + pivots + 3 * (P - 1) + P + 2 * (P - 1)
    return dict(chain_ops=ops, chain_ms=1e3 * ops * OP_CYCLES / CLOCK_HZ)


def lm_adversarial(N: int, P: int, dtype, device, seed: int = 11):
    """Four (N, P) systems (J, r, lam) on which a solve's corner cases show:
    0, columns P-2 and P-1 equal and opposite, ten times column 0, so that
    rows P-2 and P-1 tie for the first pivot (the first must win); 1, a zero
    column and lam 0, a zero pivot (the step is not finite); 2, a NaN in J;
    3, columns scaled over 10^8. Needs P >= 3 and N >= 4."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(4, N, P))
    t = P - 2
    J[0, :, t] = 10.0 * J[0, :, 0] + 0.1 * rng.normal(size=N)
    J[0, :, t + 1] = -J[0, :, t]
    J[1, :, 1] = 0.0
    J[2, 3, P // 2] = np.nan
    J[3] *= 10.0 ** rng.uniform(-8, 0, size=(1, P))
    r = rng.normal(size=(4, N))
    lam = np.array([1e-3, 0.0, 1e-2, 1e-6])
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in (J, r, lam))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, type and bits, NaNs compared by their places only (the
    host's and the card's NaNs differ in sign and payload)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(na, nb) and torch.equal(a[~na].view(ints), b[~nb].view(ints))


def library_ms(fn, n: int = N_TIMED) -> float | None:
    """Device time of one library call in ms: ``torch.profiler`` over n
    calls of fn(), the device time of every kernel, copy and set the window
    ran, over n; None where it recorded none."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 / n if total_us > 0 else None


def require_lm_adversarial(tag: str, N: int, P: int, dtype, device) -> None:
    """lm_solve_small on lm_adversarial's batch, both dampings: the same
    bits as its twin (NaNs in the same places), each system alone as in
    the batch, the zero pivot's step not finite."""
    J, r, lam = lm_adversarial(N, P, dtype, device)
    for marquardt in (False, True):
        got = cuda.lm_solve_small(J, r, lam, marquardt)
        if not same_bits(got, lm.lm_step_plain(J, r, lam, marquardt)):
            raise AssertionError(f"{tag} adversarial (marquardt={marquardt}): kernel differs "
                                 f"from its plain twin")
        for i in range(J.shape[0]):
            if not same_bits(cuda.lm_solve_small(J[i], r[i], lam[i], marquardt), got[i]):
                raise AssertionError(f"{tag} adversarial system {i}: alone differs from batched")
        if torch.isfinite(got[1]).all() or not torch.isnan(got[2]).any():
            raise AssertionError(f"{tag} adversarial: the zero pivot's or the NaN's step is finite")
    print(f"[lm adversarial] {tag}: pivot tie, zero column, NaN, columns over 10^8 (N={N}, "
          f"P={P}, {str(dtype)[6:]}): bit-identical to the twin, NaNs in the same places, each "
          f"system alone as batched")


def phase_lm_kernels(calls: dict, tag: str = "") -> dict:
    """lm_solve_small and lm_row_sum against their twins on the first
    launch of each shape one enhanced step made (bit-identical), with their
    times, bounds and the time of one PyTorch call of the same function on
    the same inputs (library_ms): torch.linalg.solve_ex on the damped systems
    (the solve alone, without the normal equations), torch.sum over the rows.
    lm_solve_small also prints its chain (lm_chain) beside its bound, and is
    held to its twin on lm_adversarial's batch once for each (N, P) and
    dtype (require_lm_adversarial)."""
    rows, adversarial = {}, set()
    for name, launches in calls.items():
        first = {}
        for args in launches:
            first.setdefault(tuple(args[0].shape), args)
        measured, bounds, lib, errs = [], [], [], []
        for shape, args in first.items():
            kernel = getattr(cuda, name)
            if name == "lm_solve_small":
                J, r, lam, marquardt = args
                plain = lambda J=J, r=r, lam=lam, m=marquardt: lm.lm_step_plain(J, r, lam, m)
                A, b = lm.damped_system(J, r, lam, marquardt)
                library = lambda A=A, b=b: torch.linalg.solve_ex(A, b)
            else:
                plain = lambda x=args[0]: lm.tree_sum_plain(x)
                library = lambda x=args[0]: torch.sum(x, dim=-1)
            got, want = kernel(*args), plain()
            require_equal(f"{name}{tag} {shape}", got, want)
            errs.append(max_abs(got, want))
            t = measure(name, lambda k=kernel, a=args: k(*a), plain, 5)
            t["library_ms"] = library_ms(library)
            bd = lm_bound(name, args)
            measured.append(t)
            bounds.append(bd)
            lib.append(t["library_ms"])
            chain = ""
            if name == "lm_solve_small":
                ch = lm_chain(*shape[-2:])
                chain = f", chain {ch['chain_ops']} operations {1e3 * ch['chain_ms']:.4f} us"
                if (shape[-2:], J.dtype) not in adversarial:
                    require_lm_adversarial(f"{name}{tag} {shape}", *shape[-2:], J.dtype, J.device)
                    adversarial.add((shape[-2:], J.dtype))
            print(f"[{name}{tag}] {shape}: {times_line(t)}; one PyTorch call "
                  f"{fmt_ms(t['library_ms'])} (profiler); bound {1e3 * bd['bound_ms']:.4f} us "
                  f"({bd['bound_by']}){chain}; bit-identical to its twin")
        rows[name] = dict(max_abs_err=max(errs), **summarize(measured),
                          bound_ms=statistics.mean(bd["bound_ms"] for bd in bounds),
                          bound_by=bounds[0]["bound_by"],
                          library_ms=None if None in lib else statistics.mean(lib),
                          shapes=[list(s) for s in first])
        print(f"[{name}{tag}] {len(launches)} launches a step over {len(first)} shapes: "
              f"device {fmt_ms(rows[name]['device_ms'])} ({rows[name]['device_method']}, the "
              f"mean over the shapes); one PyTorch call {fmt_ms(rows[name]['library_ms'])}")
    return rows


# The plain version of sea_thru_fit for each model, with the wrapper's
# arguments after the model.
FIT_PLAIN = {"backscatter": backscatter_lm_plain, "attenuation": beta_lm_plain}
FIT_CONFIG = {"backscatter": backscatter_config, "attenuation": beta_config}
# Operations of one sample of each model (csrc/sea_thru_fit.cu, an exp or a
# log one operation): its weighted residual and Jacobian row, and its error
# leaf; and the longest chains of dependent operations through each.
FIT_SAMPLE_OPS = {"backscatter": (85, 39), "attenuation": (94, 42)}
FIT_SAMPLE_CHAIN = {"backscatter": (15, 11), "attenuation": (16, 12)}


def record_fit_calls(fn) -> list:
    """Run fn() and return the arguments of every sea_thru_fit launch it
    made, cloned: (model, colour, z, valid, x0, config)."""
    calls, wrapper = [], cuda.sea_thru_fit

    def launch(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return wrapper(*args)

    cuda.sea_thru_fit = launch
    try:
        fn()
    finally:
        cuda.sea_thru_fit = wrapper
    return calls


@contextlib.contextmanager
def fits_by_loop(kernels: bool = True):
    """Inside, every Sea-thru fit runs its plain version (the loop of
    ops/lm.py::lm_solve) instead of sea_thru_fit: its steps and error sums
    by lm_solve_small and lm_row_sum (the path before the fit was one
    launch), or, kernels=False, by their twins."""
    wrapper = cuda.sea_thru_fit
    cuda.sea_thru_fit = lambda model, *args: FIT_PLAIN[model](*args, kernels=kernels)
    try:
        yield
    finally:
        cuda.sea_thru_fit = wrapper


def run_fit_loops(calls: list) -> None:
    """Each recorded fit by its plain version with the LM kernels."""
    for model, *args in calls:
        FIT_PLAIN[model](*args, kernels=True)


def record_fit_loops(calls: list, tag: str) -> dict:
    """record_lm_calls over one step's recorded fits run by their loop with
    the LM kernels (run_fit_loops), which must launch PER_ENHANCE_LOOP."""
    lm_calls = record_lm_calls(lambda: run_fit_loops(calls))
    got = {k: len(v) for k, v in lm_calls.items()}
    if got != PER_ENHANCE_LOOP:
        raise AssertionError(f"{tag}: the fits' loop launched {got}, expected {PER_ENHANCE_LOOP}")
    return lm_calls


def fit_routes(call: tuple) -> dict:
    """A recorded fit three ways: sea_thru_fit, its plain version on the
    card (the LM kernels' twins: no kernel of the port), and the plain
    version with lm_solve_small and lm_row_sum."""
    model, *args = call
    return {"sea_thru_fit": cuda.sea_thru_fit(model, *args),
            "plain": FIT_PLAIN[model](*args, kernels=False),
            "lm kernels": FIT_PLAIN[model](*args, kernels=True)}


def fit_tag(call: tuple) -> str:
    model, colour, z, valid, x0, config = call
    return (f"{model} N={z.shape[-1]} fits {tuple(z.shape[:-1]) + tuple(x0.shape[z.ndim - 1:-1])} "
            f"{config.max_iters} iterations")


def require_same_fit(tag: str, call: tuple) -> dict:
    """sea_thru_fit equal to its plain version and to the LM kernels' path
    in x, error, lambda and the accepted steps, bit for bit (NaNs in the
    same places); and, for a batch of cameras, each camera's fit alone
    equal to its fit in the batch. Returns the three results."""
    routes = fit_routes(call)
    got = routes["sea_thru_fit"]
    for name in ("plain", "lm kernels"):
        for field in got._fields:
            a, b = getattr(got, field), getattr(routes[name], field)
            if not same_bits(a, b):
                raise AssertionError(f"{tag} ({fit_tag(call)}): sea_thru_fit's {field} differs "
                                     f"from the {name} path's (max |diff| {max_abs(a, b)})")
    model, colour, z, valid, x0, config = call
    if z.ndim > 1:
        per_cam = x0.ndim > (1 if model == "backscatter" else 2)
        for b in range(z.shape[0]):
            one = cuda.sea_thru_fit(model, colour[b], z[b], valid[b], x0[b] if per_cam else x0,
                                    config)
            for field in got._fields:
                if not same_bits(getattr(one, field), getattr(got, field)[b]):
                    raise AssertionError(f"{tag} ({fit_tag(call)}): camera {b}'s fit alone "
                                         f"differs from the batch's in {field}")
    return routes


def check_fits(tag: str, calls: list) -> None:
    """require_same_fit on every recorded fit."""
    if not calls:
        raise AssertionError(f"{tag}: no Sea-thru fit was recorded")
    for call in calls:
        require_same_fit(tag, call)
    acc = [int(cuda.sea_thru_fit(*call).n_accepted.sum()) for call in calls]
    shapes = ", ".join(sorted({fit_tag(c) for c in calls}))
    print(f"[sea_thru_fit {tag}] {len(calls)} fits ({shapes}): "
          f"x, error, lambda and accepted steps bit-identical to the plain version on the card "
          f"and to the lm_solve_small + lm_row_sum path, each camera alone as in its batch; "
          f"accepted steps {acc}")


def fit_samples(model: str, B: int, N: int, device, seed: int = 0):
    """B cameras of unlike water, N samples each, drawn from the model with
    1% noise, a tenth of them invalid: (colour, z, valid), float32."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.5, 8.0, (B, N, 1))
    if model == "backscatter":
        Bc, beta_b = rng.uniform(0.03, 0.2, (B, 1, 3)), rng.uniform(0.3, 1.5, (B, 1, 3))
        Jp, beta_d = rng.uniform(0.01, 0.1, (B, 1, 3)), rng.uniform(0.5, 1.5, (B, 1, 3))
        colour = Bc * (1 - np.exp(-beta_b * z)) + Jp * np.exp(-beta_d * z)
    else:
        a, c = rng.uniform(0.2, 1.2, (B, 1, 3)), rng.uniform(0.5, 3.0, (B, 1, 3))
        b, d = rng.uniform(-0.4, 0.0, (B, 1, 3)), rng.uniform(-2.5, -1.0, (B, 1, 3))
        colour = np.exp(-(a * np.exp(b * z) + c * np.exp(d * z)) * z)
    colour = colour * (1 + 0.01 * rng.normal(size=colour.shape))
    valid = rng.random((B, N)) < 0.9
    return (torch.as_tensor(colour, dtype=torch.float32, device=device),
            torch.as_tensor(z[..., 0], dtype=torch.float32, device=device),
            torch.as_tensor(valid, device=device))


def fit_start(model: str, device, G: int = 2) -> torch.Tensor:
    """The enhancement's starts: the D5 defaults, or G of the beta guesses
    (a third the mean of the two)."""
    if model == "backscatter":
        return backscatter_start(device)
    guesses = beta_guesses(device)
    return torch.cat([guesses, guesses.mean(0, keepdim=True)])[:G].contiguous()


def fit_adversarial(N: int, device, seed: int = 13) -> list:
    """(tag, call) fits of each model, one camera, on which the kernel's
    corner cases show: no valid sample (a zero system, so every step is not
    finite and zeroed); a valid sample at z = inf (NaNs in J, so every step
    is zeroed); a quarter of the ranges 0, valid (signed zeros in J); a
    start 10^4 times the model's (steps far from the data); and a start
    whose model overflows (an infinite error and lambda NaN from the
    start)."""
    out = []
    for model in FIT_PLAIN:
        colour, z, valid = (t[0] for t in fit_samples(model, 1, N, device, seed))
        x0 = fit_start(model, device)
        config = FIT_CONFIG[model]()
        cases = {"no valid sample": (colour, z, torch.zeros_like(valid), x0)}
        z_inf = z.clone()
        z_inf[3] = float("inf")
        cases["a sample at z = inf"] = (colour, z_inf, torch.ones_like(valid), x0)
        z_zero = z.clone()
        z_zero[:N // 4] = 0.0
        cases["zero ranges"] = (colour, z_zero, torch.ones_like(valid), x0)
        cases["a start 10^4 times the model's"] = (colour, z, valid, x0 * 1e4)
        blow = x0.clone()
        if model == "backscatter":
            blow[9:12] = -60.0  # exp(60 z) overflows
        else:
            blow[..., 0:3] = 1e30  # beta * beta overflows
        cases["a start whose model overflows"] = (colour, z, valid, blow)
        out += [(f"{model}: {tag}", (model, *args, config)) for tag, args in cases.items()]
    return out


def fit_bound(call: tuple, result) -> dict:
    """Bound of one sea_thru_fit launch: its samples read once (the colour
    triple, z and valid a camera's sample), its starts and results written
    once, and the operations this run's fits needed at 67 TFLOP/s: the
    residual and Jacobian of every sample and the normal equations'
    P(P+1)/2 + P dot products at the start and after each accepted step,
    every iteration's solve (the damping, the elimination and the back
    substitution) and every error (the start's and one an iteration), each
    a sample's leaf and the tree."""
    model, colour, z, valid, x0, config = call
    N, P = z.shape[-1], 12
    fits, cams = result.error.numel(), z.numel() // N
    nbytes = cams * N * (4 * 3 + 4 + 1) + 4 * x0.numel() + fits * 4 * (P + 3)
    res_ops, err_ops = FIT_SAMPLE_OPS[model]
    solve = 2 * P * P + sum((P - k - 1) * (3 + 2 * (P - k - 1)) for k in range(P)) + P * P
    normal = N * res_ops + 2 * N * (P * (P + 1) // 2 + P)
    iters = config.max_iters
    ops = (float(result.n_accepted.sum()) + fits) * normal \
        + fits * (iters * solve + (iters + 1) * (N * err_ops + N))
    return bound(nbytes, ops)


def fit_chain(call: tuple, result) -> dict:
    """The longest chain of dependent operations of the fit that accepted
    the most steps, each at OP_CYCLES: the normal equations (a sample's
    residual and Jacobian, a product and the tree's levels) at the start and
    after each accepted step; every iteration's solve (lm_chain without its
    tree), step (a product, a sum and the projection), error (a sample's
    leaf, the tree's levels and the quotient) and acceptance (a comparison
    and lambda's product and clamp); and the start's error."""
    model, colour, z, valid, x0, config = call
    N = z.shape[-1]
    levels = max(N - 1, 0).bit_length()
    res_chain, err_chain = FIT_SAMPLE_CHAIN[model]
    normal = res_chain + 1 + levels
    solve = lm_chain(N, 12)["chain_ops"] - 1 - levels
    error = err_chain + levels + 1
    iters = config.max_iters
    ops = (int(result.n_accepted.max()) + 1) * normal + iters * (solve + 3 + error + 3) + error
    return dict(chain_ops=ops, chain_ms=1e3 * ops * OP_CYCLES / CLOCK_HZ)


def phase_fit_kernel(calls: list, tag: str = "") -> dict:
    """sea_thru_fit on the first recorded fit of each model and shape:
    equal to its plain version and to the LM kernels' path
    (require_same_fit), its device time (profiler, graph replay), call
    time, the plain version's and the LM kernels' path's call times, its
    bound and chain; with tag "" also the adversarial fits
    (fit_adversarial). Returns sea_thru_fit's row: the means over the
    shapes, each shape under "fits"."""
    first = {}
    for call in calls:
        first.setdefault(fit_tag(call), call)
    measured, bounds, shapes, errs = [], [], [], []
    for name, call in first.items():
        routes = require_same_fit(f"sea_thru_fit{tag}", call)
        errs.append(max(max_abs(routes["sea_thru_fit"].x, routes["plain"].x),
                        max_abs(routes["sea_thru_fit"].error, routes["plain"].error)))
        model, *args = call
        kernel = lambda c=call: cuda.sea_thru_fit(*c)
        plain = lambda m=model, a=args: FIT_PLAIN[m](*a, kernels=False)
        t = measure("sea_thru_fit", kernel, plain, 3)
        t["lm_kernels_ms"] = call_ms(lambda m=model, a=args: FIT_PLAIN[m](*a, kernels=True), 3)
        bd = fit_bound(call, routes["sea_thru_fit"])
        ch = fit_chain(call, routes["sea_thru_fit"])
        acc = routes["sea_thru_fit"].n_accepted.flatten().tolist()
        measured.append(t)
        bounds.append(bd)
        shapes.append(dict(fit=name, accepted=acc, **t, **bd, **ch))
        print(f"[sea_thru_fit{tag}] {name}: {times_line(t)}; the loop with lm_solve_small and "
              f"lm_row_sum {t['lm_kernels_ms']:.4f} ms a call; bound {1e3 * bd['bound_ms']:.4f} us "
              f"({bd['bound_by']}), chain {ch['chain_ops']} operations "
              f"{1e3 * ch['chain_ms']:.4f} us; accepted steps {acc}; x, error, lambda and "
              f"accepted steps bit-identical to the plain version and to the LM kernels' path")
    if tag == "":
        N = calls[0][2].shape[-1]
        for name, call in fit_adversarial(N, calls[0][2].device):
            routes = require_same_fit(f"sea_thru_fit adversarial, {name}", call)
            r = routes["sea_thru_fit"]
            print(f"[sea_thru_fit adversarial] {name} (N={N}): bit-identical to the plain "
                  f"version and the LM kernels' path; error {r.error.flatten().tolist()}, lambda "
                  f"{r.lambda_.flatten().tolist()}, accepted {r.n_accepted.flatten().tolist()}, "
                  f"max |x| {float(r.x.abs().max()):.6e}")
    row = dict(max_abs_err=max(errs), **summarize(measured),
               bound_ms=statistics.mean(bd["bound_ms"] for bd in bounds),
               bound_by=bounds[0]["bound_by"], library_ms=None,
               lm_kernels_ms=statistics.mean(t["lm_kernels_ms"] for t in measured),
               chain_ms=statistics.mean(s["chain_ms"] for s in shapes), fits=shapes)
    print(f"[sea_thru_fit{tag}] {len(calls)} launches a step over {len(first)} shapes: device "
          f"{fmt_ms(row['device_ms'])} ({row['device_method']}, the mean over the shapes; a "
          f"step's fits {fmt_ms(sum(s['profiler_ms'] or s['graph_ms'] for s in shapes))}); no "
          f"single PyTorch call computes the fit")
    return {"sea_thru_fit": row}


def require_enhance_close(tag: str, batched, single, nudged) -> str:
    """The batched enhanced image within the enhance tolerance of the
    one-camera one (see the module docstring); nudged is the one-camera
    enhancement of the input moved by one ulp."""
    diff = (batched - single).abs().flatten().float()
    spread = (nudged - single).abs().flatten().float()
    q = torch.tensor([0.5, 0.999], device=diff.device)
    dq = [float(v) for v in torch.quantile(diff, q)]
    sq = [float(v) for v in torch.quantile(spread, q)]
    line = (f"|batched - single| median {dq[0]:.3e}, 99.9% {dq[1]:.3e}, max {float(diff.max()):.3e}"
            f"; one-ulp spread median {sq[0]:.3e}, 99.9% {sq[1]:.3e}")
    if not (dq[0] <= 2 * sq[0] and dq[1] <= 2 * sq[1]):
        raise AssertionError(f"{tag}: enhanced image outside the enhance tolerance: {line}")
    return line


def phase_batched(canvas, rig, config, rows: dict, l2: dict) -> dict:
    """perception_step on N_CAMERAS cameras in one call (see the module
    docstring, phase 12); returns the batched kernels' rows, each with its
    launches on the batched path."""
    dev = torch.device("cuda", 0)
    B = N_CAMERAS
    pairs = [make_inputs(canvas, i) for i in range(B)]
    left = torch.as_tensor(np.stack([l for l, _ in pairs]), device=dev)
    right = torch.as_tensor(np.stack([r for _, r in pairs]), device=dev)
    krows = phase_kernels(left, right, l2, f" B={B}")
    krows.update(phase_strip_kernels(left, right, l2, f"strips B={B}"))
    phase_kernels(left, right, None, f" farm B={B}", FARM_SCALE)
    for name, row in krows.items():
        one = rows[name]
        print(f"[batched kernels] {name}, B={B} in one launch: device {row['device_ms']:.5f} ms "
              f"against {one['device_ms']:.5f} at B=1 ({row['device_ms'] / one['device_ms']:.3f}x); "
              f"bound {row['bound_ms']:.5f} ms against {one['bound_ms']:.5f}"
              + (f"; chain {row['chain_ms']:.5f} ms ({row['chain_trips']} trips) against "
                 f"{one['chain_ms']:.5f}" if "chain_ms" in row else ""))
    configs = {
        "(H, W, D)": (config, PER_FRAME),
        "strips": (dataclasses.replace(config, use_strip_volumes=True), PER_STRIP_FRAME),
        f"farm (internal_scale={FARM_SCALE})": (
            dataclasses.replace(config, internal_scale=FARM_SCALE), PER_FRAME),
    }
    for tag, (cfg, per_call) in configs.items():
        def step(l=left, r=right, cfg=cfg):
            return perception_step(l, r, rig, cfg, device=dev)

        singles = [step(left[b], right[b]) for b in range(B)]
        step()  # warm-up
        torch.cuda.synchronize()
        cuda.reset_launches()
        out = step()
        launches = dict(cuda.LAUNCHES)
        require_launches(f"batched {tag}", launches, per_call, 1)
        fits = record_fit_calls(step)
        check_fits(f"batched {tag}", fits)
        if cfg is config:
            krows.update(phase_fit_kernel(fits, f" B={B}"))
        for k, n in launches.items():
            if n and k in krows:
                krows[k]["launches"] = n
        if out.disparity.shape != (B, H, W) or out.enhanced_left.shape != (B, H, W, 3):
            raise AssertionError(f"batched {tag}: bad output shapes")
        for field, t in out._asdict().items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"batched {tag}: non-finite {field}")
        lines = []
        for b, one in enumerate(singles):
            require_equal(f"batched {tag} camera {b} disparity vs one camera's", out.disparity[b],
                          one.disparity)
            require_equal(f"batched {tag} camera {b} depth vs one camera's", out.depth[b],
                          one.depth)
            nudged, _ = enhance_underwater(left[b] * float(np.float32(1 + 2.0**-23)), one.depth,
                                           cfg.enhance)
            lines.append(require_enhance_close(f"batched {tag} camera {b}", out.enhanced_left[b],
                                               one.enhanced_left, nudged))
            med, frac = accuracy(out.disparity[b])
            lines[-1] += f"; median |disp - {TRUE_DISP}| {med:.4f} px, valid {frac:.4f}"
            # The farm point's quarter resolution is held to its one-camera
            # step only.
            if cfg.internal_scale == SCALE and not (med < 1.0 and frac > 0.5):
                raise AssertionError(f"batched {tag} camera {b}: median |disp - {TRUE_DISP}| "
                                     f"{med} px, valid {frac}")
        sites = sync_sites(step)
        torch.cuda.synchronize()
        print_syncs(f"batched {tag}", sites)
        if sites:
            raise AssertionError(f"batched {tag}: perception_step made {len(sites)} host syncs")

        calls_b = call_ms(step, 5)
        calls_1 = call_ms(lambda: step(left[0], right[0]), 5)
        graph_b = phase_graph(left, right, rig, cfg, out.disparity, [calls_b], None,
                              f"batched {tag} graph, B={B}")
        graph_1 = phase_graph(left[0], right[0], rig, cfg, singles[0].disparity, [calls_1], None,
                              f"batched {tag} graph, B=1")
        count_1 = kernel_count(lambda: step(left[0], right[0]))
        count_b = kernel_count(step)
        nodes_1 = graph_kernel_nodes(lambda: step(left[0], right[0]))
        nodes_b = graph_kernel_nodes(step)
        mem_1 = peak_bytes(lambda: step(left[0], right[0]))
        mem_b = peak_bytes(step)
        for b, line in enumerate(lines):
            print(f"[batched {tag}] camera {b}: disparity and depth equal to the one-camera "
                  f"step's; enhanced {line}")
        print(f"[batched {tag}] B={B}: {calls_b:.3f} ms a call by calls, {graph_b:.3f} ms by "
              f"graph ({B * 1000.0 / graph_b:.1f} fps per GPU; by calls "
              f"{B * 1000.0 / calls_b:.1f}); B=1: {calls_1:.3f} ms by calls, {graph_1:.3f} ms "
              f"by graph ({1000.0 / graph_1:.1f} fps); graph B={B} / ({B} x B=1) "
              f"{graph_b / (B * graph_1):.3f}; launches {launches}; CUDA kernels a call "
              f"(profiler) B=1 {sum(count_1.values()):.1f}, B={B} {sum(count_b.values()):.1f}, "
              f"kernel nodes of its CUDA graph B=1 {nodes_1}, B={B} {nodes_b}; peak device memory "
              f"(max_memory_allocated) B=1 {mem_1[0] / 2**20:.1f} MiB ({mem_1[1] / 2**20:.1f} the "
              f"call's own), B={B} {mem_b[0] / 2**20:.1f} MiB ({mem_b[1] / 2**20:.1f})")
        print(f"[batched {tag}] kernels a call, B={B} less B=1 (profiler): "
              f"{count_changes(count_1, count_b)}")
    return krows


def require_camera_equal(tag: str, out, b: int, o1, left_f, config) -> tuple:
    """Camera b of a fleet frontend call, out, against its one-camera
    full_frontend_step o1 on its frame left_f (phase 13's rule): disparity,
    depth, labels, slot ids and alive set equal, pixels within 1e-3 px on 99%
    of alive slots, the enhanced image within the enhance tolerance. Returns
    whether the pixels, the stripe disparities and the enhanced image are
    bit-identical."""
    nudged, _ = enhance_underwater(left_f * float(np.float32(1 + 2.0**-23)),
                                   o1.perception.depth, config.enhance)
    require_enhance_close(f"{tag} enhanced image", out.perception.enhanced_left[b],
                          o1.perception.enhanced_left, nudged)
    require_equal(f"{tag} disparity map vs one camera's", out.perception.disparity[b],
                  o1.perception.disparity)
    require_equal(f"{tag} depth vs one camera's", out.perception.depth[b], o1.perception.depth)
    require_equal(f"{tag} labels vs one camera's", out.mesher.labels[b], o1.mesher.labels)
    require_equal(f"{tag} slot ids vs one camera's", out.tracker_state.table.ids[b],
                  o1.tracker_state.table.ids)
    require_equal(f"{tag} alive vs one camera's", out.mesher.alive[b], o1.mesher.alive)
    alive = o1.mesher.alive
    dpx = (out.tracker_state.table.pixels[b] - o1.tracker_state.table.pixels)[alive]
    close = float((dpx.abs().amax(-1) <= 1e-3).float().mean()) if alive.any() else 1.0
    if close < 0.99:
        raise AssertionError(f"{tag}: pixels within 1e-3 px on {close} of alive slots")
    return (torch.equal(out.tracker_state.table.pixels[b], o1.tracker_state.table.pixels),
            torch.equal(out.mesher.disparities[b], o1.mesher.disparities),
            torch.equal(out.perception.enhanced_left[b], o1.perception.enhanced_left))


def fleet_frames(canvas, n: int, phase: int, dev, shift: int = SHIFT) -> list:
    """n calls' uint8 mono frames of N_CAMERAS cameras, (left, right) each
    (B, H, W): camera b's frame i is frame i + phase * b of the sequence
    moving -shift px a frame."""
    frames = []
    for i in range(n):
        pairs = [make_mono_u8(canvas, i + phase * b, shift=shift) for b in range(N_CAMERAS)]
        frames.append(tuple(torch.as_tensor(np.stack(side), device=dev) for side in zip(*pairs)))
    return frames


def fleet_camera_alone(tag: str, b: int, frames: list, outs: list, prev0, rig, config, params,
                       dev, per_call: dict | None = None) -> dict:
    """Camera b of the fleet calls outs, made on the last len(outs) of
    frames (fleet_frames) from the previous grays prev0, against camera b
    alone: its uint8 mono frames through full_frontend_step from a new
    state and prev0[b] over every frame, each call launching per_call where
    given, each compared call held to phase 13's rule (require_camera_equal).
    Returns the state before the first compared call (start), the compared
    calls' outputs (singles) and their ms a call by calls (ms_call), the
    counts of compared calls whose pixels, stripe disparities and enhanced
    image are bit-identical (exact), and the max |enhanced| batched and
    alone (enh_max)."""
    first = len(frames) - len(outs)
    st1 = StereoTrackerState.create(params.tracker, image_shape=(H, W), device=dev)
    gr1 = LandmarkGraph.create(params.tracker.capacity, device=dev)
    prev1, singles = prev0[b], []
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i, (left, right) in enumerate(frames):
        if i == first:
            start = (st1, gr1, prev1)
            e0.record()
        if per_call is not None:
            cuda.reset_launches()
        o1, prev1 = full_frontend_step(st1, gr1, prev1, prepare_frames(left[b][None], dev)[0],
                                       prepare_frames(right[b][None], dev)[0], rig, config,
                                       params, device=dev)
        if per_call is not None:
            require_launches(f"{tag} B=1 camera {b} call {i}", dict(cuda.LAUNCHES), per_call, 1)
        st1, gr1 = o1.tracker_state, o1.graph
        if i >= first:
            singles.append(o1)
    e1.record()
    e1.synchronize()
    exact, enh_max = [0, 0, 0], [0.0, 0.0]
    for k, (out, o1) in enumerate(zip(outs, singles)):
        left_f = prepare_frames(frames[first + k][0][b][None], dev)[0]
        same = require_camera_equal(f"{tag} camera {b} call {k}", out, b, o1, left_f, config)
        exact = [e + x for e, x in zip(exact, same)]
        enh_max = [max(enh_max[0], float(out.perception.enhanced_left[b].abs().max())),
                   max(enh_max[1], float(o1.perception.enhanced_left.abs().max()))]
    return dict(start=start, singles=singles, ms_call=e0.elapsed_time(e1) / len(singles),
                exact=exact, enh_max=enh_max)


def phase_fleet(canvas, rig, rows: dict, dev) -> dict:
    """The fleet frontend (see the module docstring, phase 13); returns
    lk_track's row at N_CAMERAS cameras, with its launches a call."""
    B = N_CAMERAS
    config = PerceptionConfig(engine="patchmatch", max_disp=MAX_DISP, internal_scale=FARM_SCALE)
    params = ObjectMesherDeviceParams()
    frames = fleet_frames(canvas, 5 + N_FRAMES + 1, FLEET_PHASE, dev)

    def fleet_step(st, gr, prev, left, right):
        return multi_camera_frontend_step(st, gr, prev, left, right, rig, config, params,
                                          device=dev)

    def one_step(st, gr, prev, left, right):
        """One camera's full_frontend_step on its uint8 mono frames."""
        return full_frontend_step(st, gr, prev, prepare_frames(left[None], dev)[0],
                                  prepare_frames(right[None], dev)[0], rig, config, params,
                                  device=dev)

    state, graph = create_fleet_frontend_state(B, params, image_shape=(H, W), device=dev)
    prev = to_grayscale(prepare_frames(frames[0][0], dev))
    prev0 = prev

    def step(i):
        nonlocal state, graph, prev
        out, prev = fleet_step(state, graph, prev, *frames[i])
        state, graph = out.tracker_state, out.graph
        return out

    for i in range(4):
        out = step(i)
        if i == 0:
            alive = out.tracker_state.table.alive.sum(-1).tolist()
            if not (bool(out.mesher.is_keyframe.all()) and min(alive) >= 50):
                raise AssertionError(f"fleet first keyframe: {alive} landmarks alive")
    calls = record_lk_calls(lambda: step(4))
    torch.cuda.synchronize()
    lk_row = phase_lk_kernels(calls, f"fleet lk B={B}")["lk_track"]
    fits = record_fit_calls(lambda: perception_step(
        prepare_frames(frames[4][0], dev), prepare_frames(frames[4][1], dev), rig, config, dev))
    fit_row = phase_fit_kernel(fits, f" fleet B={B}")["sea_thru_fit"]
    loop_calls = record_fit_loops(fits, f"fleet B={B}")
    lm_rows = phase_lm_kernels(loop_calls, f" fleet B={B}")
    one = rows["lk_track"]
    print(f"[fleet lk] lk_track, {B} cameras in one launch a direction: device "
          f"{lk_row['device_ms'] * 1e3:.3f} us ({lk_row['device_method']}; graph replay "
          f"{lk_row['graph_ms'] * 1e3:.3f}) against {one['device_ms'] * 1e3:.3f} us for one camera "
          f"(phase 9; {lk_row['device_ms'] / one['device_ms']:.3f}x); bound "
          f"{lk_row['bound_ms'] * 1e3:.3f} us ({lk_row['bound_by']}) against "
          f"{one['bound_ms'] * 1e3:.3f}; chain {lk_row['chain_ms'] * 1e3:.3f} us against "
          f"{one['chain_ms'] * 1e3:.3f}")

    cuda.reset_launches()
    start_state = (state, graph, prev)
    before, outs = [state], []
    digest = torch.zeros((), device=dev, dtype=torch.float64)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    wall0 = time.perf_counter()
    t0.record()
    for i in range(5, 5 + N_FRAMES):
        out = step(i)
        m = out.mesher
        digest += (out.perception.disparity.sum() + out.perception.enhanced_left.sum()
                   + m.disparities.sum() + m.labels.sum() + m.sizes.sum())
        outs.append(out)
        before.append(state)
    t1.record()
    t1.synchronize()
    wall = (time.perf_counter() - wall0) / N_FRAMES
    launches = dict(cuda.LAUNCHES)
    ms_call = t0.elapsed_time(t1) / N_FRAMES
    require_launches(f"fleet B={B}", launches, PER_FRONTEND_FRAME, N_FRAMES)
    if launches["lk_track"] != 2 * N_FRAMES:
        raise AssertionError(f"fleet: lk_track launched {launches['lk_track']} times in "
                             f"{N_FRAMES} calls")
    check_fits(f"fleet B={B}", record_fit_calls(lambda: [perception_step(
        prepare_frames(frames[i][0], dev), prepare_frames(frames[i][1], dev), rig, config, dev)
        for i in range(5, 5 + N_FRAMES)]))

    lines = []
    for b in range(B):
        errs, disps = [], []
        for k, out in enumerate(outs):
            if out.perception.disparity.shape != (B, H, W) or out.mesher.labels.shape[0] != B:
                raise AssertionError("fleet: outputs without the camera axis")
            for field, t in (*out.perception._asdict().items(),
                             *((f, v) for f, v in out.mesher._asdict().items()
                               if v.is_floating_point())):
                if not torch.isfinite(t[b]).all():
                    raise AssertionError(f"fleet camera {b} call {k}: non-finite {field}")
            errs.append(track_error(camera(before[k].table, b), camera(before[k + 1].table, b),
                                    SHIFT))
            d = out.mesher.disparities[b][out.tracker_state.table.alive[b]]
            disps.append(d[d > 0] - TRUE_DISP)
        errs, disps = torch.cat(errs), torch.cat(disps)
        med_err, med_disp = float(errs.median()), float(disps.abs().median())
        alive = int(outs[-1].tracker_state.table.alive[b].sum())
        lines.append(f"camera {b}: median |track error| {med_err:.5f} px over "
                     f"{errs.numel() // 2} tracks, median |stripe disp - {TRUE_DISP}| "
                     f"{med_disp:.4f} px, {alive} alive, "
                     f"{int((outs[-1].mesher.sizes[b] >= 3).sum())} clusters of >= 3")
        if not (med_err < 0.1 and med_disp < 0.5 and alive >= 50):
            raise AssertionError(f"fleet {lines[-1]}")

    # Each camera against its one-camera full_frontend_step on the card.
    ms_call_1 = []  # each camera's one-camera calls, by calls
    for b in range(B):
        a = fleet_camera_alone("fleet", b, frames[:5 + N_FRAMES], outs, prev0, rig, config,
                               params, dev)
        if b == 0:
            start_1, outs_1 = a["start"], a["singles"]
        ms_call_1.append(a["ms_call"])
        (exact_px, exact_disp, exact_enh), enh_max = a["exact"], a["enh_max"]
        lines[b] += (f"; against its one-camera full_frontend_step ({a['ms_call']:.3f} ms a "
                     f"call by calls): disparity map, depth, labels, slot ids and alive set "
                     f"equal in {N_FRAMES} of {N_FRAMES} calls, pixels bit-identical in "
                     f"{exact_px}, stripe disparities bit-identical in {exact_disp}; enhanced "
                     f"image within the enhance tolerance in {N_FRAMES} of {N_FRAMES} calls, "
                     f"bit-identical in {exact_enh}, max |enhanced| {enh_max[0]:.6e} "
                     f"batched, {enh_max[1]:.6e} one camera")
    for line in lines:
        print(f"[fleet] {line}")

    sites = sync_sites(lambda: step(5 + N_FRAMES))
    torch.cuda.synchronize()
    print_syncs(f"fleet B={B}", sites)
    if sites:
        raise AssertionError(f"fleet: multi_camera_frontend_step made {len(sites)} host syncs")

    timed = frames[5:5 + N_FRAMES]
    graph_b = frontend_graph(fleet_step, start_state, timed, outs[0], outs[-1],
                             f"fleet graph B={B}")
    graph_1 = frontend_graph(one_step, start_1, [(l[0], r[0]) for l, r in timed], outs_1[0],
                             outs_1[-1], "fleet graph B=1")
    args_b = (*start_state, *timed[0])
    args_1 = (*start_1, timed[0][0][0], timed[0][1][0])
    count_1 = kernel_count(lambda: one_step(*args_1))
    count_b = kernel_count(lambda: fleet_step(*args_b))
    nodes_1 = graph_kernel_nodes(lambda: one_step(*args_1))
    nodes_b = graph_kernel_nodes(lambda: fleet_step(*args_b))
    mem_1 = peak_bytes(lambda: one_step(*args_1))
    mem_b = peak_bytes(lambda: fleet_step(*args_b))
    print(f"[fleet] B={B} (uint8 mono, internal_scale={FARM_SCALE}, mesher_scale=1): "
          f"{ms_call:.3f} ms a call by calls (host {1000.0 * wall:.3f} ms; one camera "
          f"{statistics.mean(ms_call_1):.3f}), {graph_b:.3f} ms by "
          f"graph: {B * 1000.0 / graph_b:.1f} fps per GPU (by calls {B * 1000.0 / ms_call:.1f}); "
          f"one camera, full_frontend_step at the same point: {graph_1:.3f} ms by graph "
          f"({1000.0 / graph_1:.1f} fps); graph B={B} / ({B} x B=1) {graph_b / (B * graph_1):.3f}; "
          f"digest {float(digest):.6e}; launches {launches} over {N_FRAMES} calls; CUDA kernels "
          f"a call (profiler) B=1 {sum(count_1.values()):.1f}, B={B} {sum(count_b.values()):.1f}, "
          f"kernel nodes of its CUDA graph B=1 {nodes_1}, B={B} {nodes_b}; peak device memory "
          f"(max_memory_allocated) B=1 {mem_1[0] / 2**20:.1f} MiB ({mem_1[1] / 2**20:.1f} the "
          f"call's own), B={B} {mem_b[0] / 2**20:.1f} MiB ({mem_b[1] / 2**20:.1f})")
    print(f"[fleet] kernels a call, B={B} less B=1 (profiler): {count_changes(count_1, count_b)}")

    # A call and its two halves by calls, at N_CAMERAS and at one camera,
    # each call's outputs dropped before the next (the timed loop above
    # keeps every call's).
    from ocean_perception_tpu_torch.mesher.object_mesher import mesher_device_step

    fxb = torch.full((), float(np.float32(rig.fx) * np.float32(rig.baseline)), device=dev)
    lefts, rights = (prepare_frames(t, dev) for t in timed[0])
    grays = to_grayscale(lefts), to_grayscale(rights)
    stages = {
        f"multi_camera_frontend_step, B={B}": lambda: fleet_step(*args_b),
        "full_frontend_step, B=1": lambda: one_step(*args_1),
        f"perception_step, B={B}": lambda: perception_step(lefts, rights, rig, config, dev),
        "perception_step, B=1": lambda: perception_step(lefts[0], rights[0], rig, config, dev),
        f"mesher_device_step, B={B}": lambda: mesher_device_step(*start_state, *grays, fxb,
                                                                 params),
        "mesher_device_step, B=1": lambda: mesher_device_step(*start_1, grays[0][0],
                                                              grays[1][0], fxb, params),
    }
    print("[fleet stages] by calls: " + "; ".join(
        f"{name} {call_ms(fn, 5):.3f} ms" for name, fn in stages.items()))
    return (dict(lk_row, launches=launches["lk_track"] // N_FRAMES),
            dict(fit_row, launches=launches["sea_thru_fit"] // N_FRAMES),
            {k: dict(row, launches=len(loop_calls[k])) for k, row in lm_rows.items()})


FARM_YAML = "config/nodes/FarmPerceptionNode.yaml"
MESHER_YAML = "config/nodes/ObjectMesherNode.yaml"
FARMSIM_YAML = "config/shared/Farmsim.yaml"
NODE_STEPS = 12  # fleet frames of phase 14 (a): edges join the graph at 7 observations
NODE_TIMED = 8   # phase 14 (b)'s timed fleet steps, after NODE_WARMUP
NODE_WARMUP = 2
DEAD_STEPS = 3   # phase 14 (b): fleet steps with camera 3 silent
MESHER_FRAMES = 12  # phase 15


def u8_stereo(ts: int, cam: int, left: np.ndarray, right: np.ndarray) -> StereoImageMessage:
    """A uint8 mono stereo frame as a farm camera publishes it."""
    h, w = left.shape
    return StereoImageMessage(ts, cam, ImageMessage(ts, w, h, 1, "u8", left.tobytes()),
                              ImageMessage(ts, w, h, 1, "u8", right.tobytes()))


def mesh_sink(bus, channels: list) -> dict:
    """Every MeshMessage of each channel, in order."""
    got = {c: [] for c in channels}
    for c in channels:
        bus.subscribe(c, lambda _c, m, c=c: got[c].append(m))
    return got


def direct_fleet(frames, rig, config, params, mesher_scale, vertex_min_obs, disparity_scale,
                 dev, live=None):
    """The farm node's work without the node: multi_camera_frontend_step on
    the stacked uint8 frames, then build_meshes of each live camera; returns
    each camera's (timestamp, vertices, triangles) of the meshes with
    triangles, and the seconds of each step and of its Delaunay."""
    B = len(frames[0][0])
    s = mesher_scale
    H_, W_ = frames[0][0][0].shape
    state, graph = create_fleet_frontend_state(B, params, image_shape=(H_ // s, W_ // s),
                                               device=dev)
    mesher_rig = rig.rescale(1.0 / s) if s > 1 else rig
    prev, meshes, step_s, delaunay_s = None, [[] for _ in range(B)], [], []
    for k, (lefts, rights) in enumerate(frames):
        t0 = time.perf_counter()
        bl = torch.from_numpy(np.stack(lefts)).to(dev)
        br = torch.from_numpy(np.stack(rights)).to(dev)
        if prev is None:
            prev = bl.float() / torch.full((), 255.0, device=dev)
            for _ in range(s.bit_length() - 1):
                prev = pyr_down(prev)
        out, prev = multi_camera_frontend_step(state, graph, prev, bl, br, rig, config, params,
                                               mesher_scale=s, device=dev)
        state, graph = out.tracker_state, out.graph
        host = type(out.mesher)(*(t.cpu() for t in out.mesher))
        t1 = time.perf_counter()
        for b in range(B):
            if live is not None and not live(k, b):
                continue
            mesh = build_meshes(type(host)(*(t[b] for t in host)), mesher_rig, disparity_scale,
                                vertex_min_obs)
            if mesh.num_triangles > 0:
                meshes[b].append((k + 1, mesh.vertices, mesh.triangles))
        t2 = time.perf_counter()
        step_s.append(t2 - t0)
        delaunay_s.append(t2 - t1)
    return meshes, step_s, delaunay_s


def require_same_meshes(tag: str, got: list, want: list) -> None:
    """Meshes received (MeshMessages) equal to the direct run's, bit for bit."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} meshes received, {len(want)} from the direct "
                             f"calls")
    for m, (ts, verts, tris) in zip(got, want):
        if m.timestamp != ts or not np.array_equal(m.vertices, verts) \
                or not np.array_equal(m.triangles, tris):
            raise AssertionError(f"{tag}: the mesh of frame {ts} differs from the direct calls'")


def phase_farm_node(canvas, dev) -> None:
    """The farm perception node on the card over an InProcessBus (see the
    module docstring, phase 14): (a) the shipped deployment, its meshes
    against the direct calls bit for bit; (b) the farm point at full width,
    timed against the direct calls, then a dead camera."""
    B = N_CAMERAS
    # (a) config/nodes/FarmPerceptionNode.yaml on the Farmsim rig.
    bus = InProcessBus()
    node = fpn.from_config(bus, FARM_YAML, FARMSIM_YAML, device=dev)
    h, w = int(node.rig.left.height), int(node.rig.left.width)
    chans = [f"farm/mesh/cam{b}" for b in range(B)]
    got = mesh_sink(bus, chans)
    frames = [tuple(zip(*[make_mono_u8(canvas, k + FLEET_PHASE * b, (h, w)) for b in range(B)]))
              for k in range(NODE_STEPS)]
    try:
        for k, (lefts, rights) in enumerate(frames):
            for b in range(B):
                bus.publish(f"sensors/stereo/cam{b}", u8_stereo(k + 1, b, lefts[b], rights[b]))
            node.wait_steps(k + 1, 120.0)
    finally:
        node.close()
    counts = (node.fleet_steps, node.frames_in, node.step_failures, node.stale_fills,
              node.rejected_frames)
    if counts != (NODE_STEPS, B * NODE_STEPS, 0, 0, 0):
        raise AssertionError(f"farm node (shipped): fleet steps, frames in, failures, stale "
                             f"fills, rejected {counts}; {NODE_STEPS} steps of {B} cameras sent")
    want, _, _ = direct_fleet(frames, node.rig, node.config, node.mesher_params,
                              node.mesher_scale, node.vertex_min_obs, node.disparity_scale, dev)
    for b, c in enumerate(chans):
        require_same_meshes(f"farm node (shipped) camera {b}", got[c], want[b])
        if not got[c]:
            raise AssertionError(f"farm node (shipped): camera {b} was never meshed")
    print(f"[farm node] shipped deployment ({FARM_YAML}, {FARMSIM_YAML}: {B} cameras of "
          f"{w}x{h} uint8 mono, internal_scale {node.config.internal_scale}, mesher_scale "
          f"{node.mesher_scale}): {NODE_STEPS} fleet steps of {NODE_STEPS} published; meshes a "
          f"camera {[len(got[c]) for c in chans]} (the first at frame "
          f"{[got[c][0].timestamp for c in chans]}), each equal bit for bit to "
          f"multi_camera_frontend_step + build_meshes on the same frames")

    # (b) The farm point at full width: 1280x720, internal_scale 4, the
    # shipped mesher params and mesher_scale 2, no enhanced tap.
    parser = YamlParser(node_path=FARM_YAML)
    params = load_mesher_params(parser).device
    cam = PinholeCamera.create(700.0, 700.0, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, baseline=0.12)
    config = PerceptionConfig(engine="patchmatch", max_disp=MAX_DISP, internal_scale=FARM_SCALE)
    scale = int(parser.get("mesher_scale"))
    bus = InProcessBus()
    node = fpn.FarmPerceptionNode(bus, rig, n_cameras=B, perception_config=config,
                                  mesher_params=params, mesher_scale=scale, device=dev)
    got = mesh_sink(bus, chans)
    n = NODE_WARMUP + NODE_TIMED + DEAD_STEPS
    frames = [tuple(zip(*[make_mono_u8(canvas, k + FLEET_PHASE * b) for b in range(B)]))
              for k in range(n)]
    walls, busy, pub = [], [], []
    # The interpreter's garbage collections during the timed steps, on any
    # thread: (start, seconds).
    collections, gc_start = [], [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            collections.append((gc_start[0], time.perf_counter() - gc_start[0]))

    gc.callbacks.append(on_gc)
    try:
        for k, (lefts, rights) in enumerate(frames):
            dead = k >= NODE_WARMUP + NODE_TIMED
            busy.append(node.busy_seconds)
            if k == NODE_WARMUP:
                window = [time.perf_counter()]
            if k == NODE_WARMUP + NODE_TIMED:
                window.append(time.perf_counter())
            t0 = time.perf_counter()
            for b in range(B - 1 if dead else B):
                bus.publish(f"sensors/stereo/cam{b}", u8_stereo(k + 1, b, lefts[b], rights[b]))
            pub.append(time.perf_counter() - t0)
            node.wait_steps(k + 1, 120.0)
            walls.append(time.perf_counter() - t0)
            busy[-1] = node.busy_seconds - busy[-1]
    finally:
        gc.callbacks.remove(on_gc)
        node.close()
    gc_ms = 1e3 * sum(t for start, t in collections if window[0] <= start < window[1]) / NODE_TIMED
    counts = (node.fleet_steps, node.step_failures, node.stale_fills, node.rejected_frames)
    if counts != (n, 0, DEAD_STEPS, 0):
        raise AssertionError(f"farm node (720p): fleet steps, failures, stale fills, rejected "
                             f"{counts}; {n} steps sent, camera {B - 1} silent in the last "
                             f"{DEAD_STEPS}")
    live = lambda k, b: not (k >= NODE_WARMUP + NODE_TIMED and b == B - 1)
    want, step_s, delaunay_s = direct_fleet(frames, rig, config, params, scale, 3, 1.0, dev, live)
    # The same direct calls on a thread of their own, as the node runs them.
    threaded = {}
    worker = threading.Thread(target=lambda: threaded.update(out=direct_fleet(
        frames, rig, config, params, scale, 3, 1.0, dev, live)))
    worker.start()
    worker.join()
    if "out" not in threaded:
        raise AssertionError("farm node (720p): the direct calls failed on a thread")
    for b, c in enumerate(chans):
        require_same_meshes(f"farm node (720p) camera {b}, direct calls on a thread", got[c],
                            threaded["out"][0][b])
    for b, c in enumerate(chans):
        require_same_meshes(f"farm node (720p) camera {b}", got[c], want[b])
    dead_meshes = [sum(m.timestamp > NODE_WARMUP + NODE_TIMED for m in got[c]) for c in chans]
    if min(dead_meshes[:-1]) == 0 or dead_meshes[-1] != 0:
        raise AssertionError(f"farm node (720p): meshes a camera while camera {B - 1} was "
                             f"silent: {dead_meshes}")
    timed = slice(NODE_WARMUP, NODE_WARMUP + NODE_TIMED)
    node_ms = 1e3 * statistics.mean(walls[timed])
    busy_ms = 1e3 * statistics.mean(busy[timed])
    pub_ms = 1e3 * statistics.mean(pub[timed])
    direct_ms = 1e3 * statistics.mean(step_s[timed])
    thread_ms = 1e3 * statistics.mean(threaded["out"][1][timed])
    delaunay_ms = 1e3 * statistics.mean(delaunay_s[timed])
    print(f"[farm node] 720p farm point ({B} cameras of {W}x{H} uint8 mono, internal_scale "
          f"{FARM_SCALE}, mesher_scale {scale}, K={params.tracker.capacity}): {NODE_TIMED} "
          f"timed fleet steps, publish to the step's last mesh {node_ms:.3f} ms a step "
          f"({1e3 / node_ms:.2f} fleet steps/s, {B * 1e3 / node_ms:.1f} camera-fps), of which "
          f"publishing the {B} frames {pub_ms:.3f} ms and the node's thread in its step "
          f"{busy_ms:.3f} ms (the interpreter's garbage collection, any thread, {gc_ms:.3f} ms "
          f"a step); the direct calls on the same frames "
          f"{direct_ms:.3f} ms a step on the main thread, {thread_ms:.3f} ms on a thread of "
          f"their own (build_meshes of {B} cameras {delaunay_ms:.3f} ms of it); the node's "
          f"own cost, its step and its wake-up and batch stacking beyond the direct calls on a "
          f"thread, {node_ms - pub_ms - thread_ms:.3f} ms a step; meshes a camera "
          f"{[len(got[c]) for c in chans]}, equal bit for bit to the direct calls'; camera "
          f"{B - 1} silent for {DEAD_STEPS} steps: {node.stale_fills} stale fills, meshes a "
          f"camera meanwhile {dead_meshes}")


def phase_mesher_node(canvas, dev) -> None:
    """The object mesher node on the card (see the module docstring, phase
    15): the shipped ObjectMesherNode.yaml on a 1280x720 rig, its meshes
    against a direct ObjectMesher on the downscaled frames, bit for bit,
    then the same frames through the shared-memory rings."""
    frames = []
    for k in range(MESHER_FRAMES):
        x0 = 100 + SHIFT * k
        frames.append((np.ascontiguousarray(canvas[:, x0 : x0 + W], np.float32),
                       np.ascontiguousarray(canvas[:, x0 + TRUE_DISP : x0 + TRUE_DISP + W],
                                            np.float32)))
    with tempfile.TemporaryDirectory() as tmp:
        rig_yaml = Path(tmp) / "rig720.yaml"
        text = Path(FARMSIM_YAML).read_text()
        text = text.replace("image_height: 376", f"image_height: {H}")
        text = text.replace("image_width: 672", f"image_width: {W}")
        text = text.replace("[336.135986, 336.135986, 335.5, 187.5]",
                            f"[700.0, 700.0, {W / 2}, {H / 2}]")
        rig_yaml.write_text(text)

        def node_and_sink():
            bus = InProcessBus()
            node = omn.from_config(bus, MESHER_YAML, str(rig_yaml), device=dev)
            return bus, node, mesh_sink(bus, [node.channel_output])[node.channel_output]

        bus, node, got = node_and_sink()
        height = node.input_height
        t0 = time.perf_counter()
        for k, (left, right) in enumerate(frames):
            bus.publish("sensors/stereo", StereoImageMessage(
                k + 1, 0, ImageMessage.from_array(k + 1, left),
                ImageMessage.from_array(k + 1, right)))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / MESHER_FRAMES

        rig = load_rig(YamlParser(shared_path=str(rig_yaml)))
        params = load_mesher_params(YamlParser(node_path=MESHER_YAML))
        mesher = ObjectMesher(params, rig.rescale(height / rig.left.height), device=dev)
        want = []
        for k, (left, right) in enumerate(frames):
            mesh = mesher.process_stereo(*(omn.downscale(torch.from_numpy(a).to(dev), height)
                                           for a in (left, right)))
            if mesh.num_triangles > 0:
                want.append((k + 1, mesh.vertices, mesh.triangles))
        if node.frames_in != MESHER_FRAMES or not want:
            raise AssertionError(f"mesher node: {node.frames_in} frames in of {MESHER_FRAMES}, "
                                 f"{len(want)} meshes from the direct calls")
        require_same_meshes("mesher node", got, want)

        bus, node, got_shm = node_and_sink()
        writers = {side: shm_ring.ShmRingWriter(str(Path(tmp) / f"{side}.ring"))
                   for side in ("left", "right")}
        try:
            for k, pair in enumerate(frames):
                for side, img in zip(("left", "right"), pair):
                    seq = writers[side].write(k + 1, img)
                    bus.publish(f"sensors/stereo_shm_{side}", ShmImageHeader(
                        k + 1, W, H, 1, seq, writers[side].path))
        finally:
            for w_ in writers.values():
                w_.close()
        require_same_meshes("mesher node over the shm rings", got_shm, want)
    print(f"[mesher node] {MESHER_YAML} on a {W}x{H} rig (mesher_input_height {height}): "
          f"{MESHER_FRAMES} raw float frames, {1e3 * wall:.3f} ms a frame "
          f"({1.0 / wall:.1f} frames/s) from publish to mesh; {len(got)} meshes, equal bit for "
          f"bit to a direct ObjectMesher on the downscaled frames; the same frames through "
          f"the shared-memory rings ({'native ring' if shm_ring.native_available() else 'none'}"
          f", {shm_ring._LIB_PATH}): the same {len(got_shm)} meshes")


VIO_YAML = "config/nodes/StateEstimatorNode.yaml"
VIO_SECONDS = 30.0      # phase 16's mission: 40 keyposes fill the window, then it slides
VIO_DISP = 14.0         # px: the textured plane sits where its disparity is whole (below)
VIO_SIN_A = 2.5         # bounded-sin motion along x (tests/synthetic_vio.py:35-40)
VIO_SIN_W = 2.0 * np.pi / 8.0
VIO_T0 = 0.1            # first frame, s
VIO_FRAME_NS, VIO_IMU_NS, VIO_DEPTH_NS = 100_000_000, 5_000_000, 500_000_000
VIO_CPU_FRAMES = 40     # frames run again on the CPU
VIO_LK_FRAME = 50       # the frame whose lk_track calls are recorded
VIO_MAX_ATE = 0.10      # m, tests/test_mission_matrix.py:28's bound for the baseline mission
VIO_CPU_TOL = 1e-3      # m and rad: card against CPU, smoother poses over the first frames
VIO_MIN_SLIDES = 10     # the window fills, then slides at least this often
VIO_WARMUP = 10         # frames before the syncs count: the one-time constant caches fill there


def vio_x(t: float) -> float:
    return VIO_SIN_A * (1.0 - np.cos(VIO_SIN_W * max(t - VIO_T0, 0.0)))


def vio_ax(t: float) -> float:
    return VIO_SIN_A * VIO_SIN_W ** 2 * np.cos(VIO_SIN_W * max(t - VIO_T0, 0.0)) if t >= VIO_T0 else 0.0


def vio_canvas(h: int, w: int, seed: int = 7) -> np.ndarray:
    """A textured plane: random noise smoothed at three scales (features for
    every LK level), in [0.1, 0.9]."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    noise = rng.random((h, w))
    tex = sum(wt * gaussian_filter(noise, s) / gaussian_filter(noise, s).std()
              for wt, s in ((0.5, 1.0), (0.3, 3.0), (0.2, 8.0)))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (0.1 + 0.8 * tex).astype(np.float32)


def vio_window(canvas: np.ndarray, x0: float, y0: float, h: int, w: int) -> np.ndarray:
    """The (h, w) view of the canvas at a subpixel offset, bilinear."""
    ix, iy = int(np.floor(x0)), int(np.floor(y0))
    fx, fy = x0 - ix, y0 - iy
    c = canvas[iy:iy + h + 1, ix:ix + w + 1]
    top = (1 - fx) * c[:-1, :-1] + fx * c[:-1, 1:]
    bot = (1 - fx) * c[1:, :-1] + fx * c[1:, 1:]
    return np.ascontiguousarray(((1 - fy) * top + fy * bot).astype(np.float32))


def vio_mission(rig, n_gravity, seconds: float = VIO_SECONDS, disp: float = VIO_DISP):
    """A synthetic mission of numpy arrays: the rig films a fronto-parallel
    textured plane at the depth where its disparity is ``disp`` px (by
    default VIO_DISP, a whole number as in tests/synthetic_vio.py's scene:
    the shipped matcher does not refine to subpixels, so a fractional
    disparity biases every stereo depth) while the body moves along x on
    the bounded sin of tests/synthetic_vio.py; 10 Hz stereo, 200 Hz IMU
    (its specific force from the analytic acceleration and the configured
    gravity), 2 Hz depth along the gravity axis. Returns the events in
    time order (IMU before a frame of the same stamp), the groundtruth
    poses at the frame times, the number of frames and the plane's depth."""
    from ocean_perception_tpu_torch.core.measurements import (DepthMeasurement,
                                                              GroundtruthPose, ImuMeasurement,
                                                              StereoImage)

    h, w = int(rig.left.height), int(rig.left.width)
    fx = float(rig.left.fx)
    depth = fx * float(rig.baseline) / disp
    px_max = fx * 2 * VIO_SIN_A / depth
    canvas = vio_canvas(h + 10, int(w + 40 + px_max + disp + 20))
    g = np.asarray(n_gravity, np.float64)
    g_unit = np.zeros(3)
    g_unit[int(np.argmax(np.abs(g)))] = np.sign(g[int(np.argmax(np.abs(g)))])
    end_ns = int(round(seconds * 1e9))
    events, gt, n_frames = [], [], 0
    for t_ns in range(int(VIO_T0 * 1e9), end_ns + 1, VIO_IMU_NS):
        t = t_ns * 1e-9
        a_world = np.array([vio_ax(t), 0.0, 0.0])
        events.append(("imu", ImuMeasurement(t_ns, np.zeros(3), a_world - g)))
        if t_ns % VIO_DEPTH_NS == 0:
            events.append(("depth", DepthMeasurement(t_ns, float(g_unit @ np.array([vio_x(t), 0, 0])))))
        if t_ns % VIO_FRAME_NS == 0:
            x0 = 40 + fx * vio_x(t) / depth
            left = vio_window(canvas, x0, 4.0, h, w)
            right = vio_window(canvas, x0 + disp, 4.0, h, w)
            events.append(("stereo", StereoImage(t_ns, 0, left, right)))
            T = np.eye(4)
            T[0, 3] = vio_x(t)
            gt.append(GroundtruthPose(t_ns, T))
            n_frames += 1
    return events, gt, n_frames, depth


class SyncLog:
    """Every host sync under torch.cuda.set_sync_debug_mode, by where it came
    from in the estimator: a checkpoint's read-back, a slide's eigh, the
    smoother's readout, the filter (with a node's published filter pose), or
    the frame (with the dataset player's filter pose); those made before
    ``armed`` is set count as warm-up (the device constants' caches fill
    once, at their first use)."""

    def __init__(self):
        self.counts = {}
        self.sites = {}
        self.armed = False

    def record(self, message, *args, **kwargs):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        names = {f.name for f in stack}
        kind = ("checkpoint" if "save_estimator" in names else
                "slide" if "slide_window" in names else
                "smoother" if "_run_smoother" in names else
                "imu" if names & {"receive_imu", "_on_imu"} else
                "frame" if names & {"receive_stereo", "_on_stereo", "on_stereo"} else "other")
        if not self.armed:
            kind = "warm-up " + kind
        self.counts[kind] = self.counts.get(kind, 0) + 1
        frames = [f for f in stack if "ocean_perception_tpu_torch" in f.filename] or stack[-3:]
        site = " <- ".join(f"{Path(f.filename).name}:{f.lineno}" for f in frames[::-1][:3])
        self.sites[(kind, site)] = self.sites.get((kind, site), 0) + 1

    def __enter__(self):
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self.record
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(*exc)


def vio_drive(est, events, until_ns=None, lk_frame=None, on_frame=None):
    """Feed the events in order; returns the smoother callbacks' (t_ns, R, p)
    (device tensors, read after the run), the mode and VO status after
    every frame, and lk_frame's recorded lk_track calls. on_frame(i) runs
    before frame i."""
    from ocean_perception_tpu_torch.vio.state_estimator import SmootherMode

    solves, modes, statuses, calls = [], [], [], None
    est.smoother_callbacks.append(
        lambda r: solves.append((est._last_smoother_t_ns, r.R, r.p)))
    frame = 0
    for kind, m in events:
        if until_ns is not None and m.timestamp > until_ns:
            break
        if kind == "imu":
            est.receive_imu(m)
        elif kind == "depth":
            est.receive_depth(m)
        else:
            if on_frame is not None:
                on_frame(frame)
            if frame == lk_frame:
                calls = record_lk_calls(lambda: est.receive_stereo(m))
            else:
                est.receive_stereo(m)
            modes.append(est.mode is SmootherMode.VISION_AVAILABLE)
            statuses.append(est.last_status)
            frame += 1
    return solves, modes, statuses, calls


def timed(spans: dict, name: str, fn):
    """fn with CUDA events recorded around each call into spans[name] (read
    them after a synchronize; perf_counter seconds without a card)."""
    def call(*args, **kwargs):
        if torch.cuda.is_available():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
        else:
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            end = time.perf_counter()
        spans.setdefault(name, []).append((start, end))
        return out

    return call


def percentiles(xs) -> str:
    a = np.asarray(xs, np.float64)
    return (f"p50 {np.percentile(a, 50):.3f}, p95 {np.percentile(a, 95):.3f}, "
            f"max {a.max():.3f} ms over {a.size}")


def device_breakdown(fn, top: int = 5) -> tuple[float, list]:
    """The device time of one call of fn() (``torch.profiler``, after a
    warm-up): the sum over its CUDA kernels in ms, and the top kernels by
    time as (name, ms, count)."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:top]


def vio_stage_times(est, frame) -> None:
    """Where an estimator step's time goes, on its state after the mission:
    each stage's call time (CUDA events around one call, the host's
    enqueue included; median after two warm-ups) and its CUDA kernels a
    call (``torch.profiler``): the frontend step and, apart, its tracker
    and its odometry (two LM runs of ``max_iters`` steps; replayed from its
    CUDA graph and by calls) and one QR of the odometry's stacked system;
    the smoother's preintegration, one linearization (``jacfwd``), one
    damped QR step, the whole update by calls and replayed from its graph,
    and a slide; the filter step replayed from its graph, and its predict
    and IMU update by calls. For the frontend step and each graph replay
    also its kernels' device time (its share of the call: the device's
    busy share) and its longest kernels."""
    from ocean_perception_tpu_torch.tracking.stereo_tracker import track_and_triangulate
    from ocean_perception_tpu_torch.vio import ekf as vekf
    from ocean_perception_tpu_torch.vio import smoother as vsm
    from ocean_perception_tpu_torch.vio.odometry import _optimize, optimize_odometry
    from ocean_perception_tpu_torch.vio.stereo_frontend import frontend_step, to_device

    dev, fe, rig = est.device, est.frontend, est.rig
    left = to_device(frame.left, dev, torch.float32)
    right = to_device(frame.right, dev, torch.float32)
    st, p, prev = fe.state, fe.params, fe._prev_left
    fxb = float(np.float32(rig.fx) * np.float32(rig.baseline))
    new_state, _ = track_and_triangulate(st, prev, left, right, fxb, p.tracker)
    a, b = st.table, new_state.table
    mask = (a.ids == b.ids) & (a.ids >= 0) & b.alive & (a.kf_disparities > 0) & (b.missed == 0)
    P0 = rig.left.backproject(a.kf_pixels, fxb / torch.clamp(a.kf_disparities, min=1e-3))
    sig = torch.full((b.capacity,), p.pixel_sigma, device=dev)
    A = torch.randn(2 * b.capacity + 6, 6, device=dev)
    win, cfg, calib = est.window, est._smoother_cfg, est.params.imu_calib
    n_steps = max(est._imu_rows)
    g, gu = est._gravity_w, est._gravity_unit_w
    pims = vsm.preintegrate_window(win, calib, n_steps)
    J, r = vsm._linearize(win, pims, g, gu, cfg)
    cov = est._last_smoother_result.cov_slot1
    ekf = est.ekf_state
    wa = torch.ones(6, dtype=torch.float64, device=dev)
    x = torch.cat([torch.full((1,), 0.005, dtype=torch.float64, device=dev), wa])
    eye = torch.eye(4, device=dev)
    graphed = list(est._smoother_steps.items())  # on the card: one bucket
    stages = [
        ("frontend_step", lambda: frontend_step(st, prev, left, right, rig, p)),
        ("  track_and_triangulate", lambda: track_and_triangulate(st, prev, left, right, fxb,
                                                                  p.tracker)),
        (f"  optimize_odometry ({int(mask.sum())} points), graph replay",
         lambda: optimize_odometry(P0, b.pixels, sig, mask, rig, params=p.odometry)),
        ("  the same by calls",
         lambda: _optimize(P0, b.pixels, sig, mask, eye, rig, p.odometry)),
        (f"  torch.linalg.qr of {tuple(A.shape)} float32", lambda: torch.linalg.qr(A)),
        (f"preintegrate_window ({win.imu_samples.shape[0]} slots, {n_steps} steps)",
         lambda: vsm.preintegrate_window(win, calib, n_steps)),
        (f"_linearize (J {tuple(J.shape)}, {J.dtype})",
         lambda: vsm._linearize(win, pims, g, gu, cfg)),
        (f"_qr_step (QR of {J.shape[0] + J.shape[1]}x{J.shape[1]})",
         lambda: vsm._qr_step(J, r, cfg)),
        (f"solve_window ({cfg.iterations} iterations)",
         lambda: vsm.solve_window(win, pims, g, gu, cfg, est._newest_slot())),
        *[(f"the smoother update ({bucket} preintegration steps + the solve), graph replay",
           lambda: update(win)) for bucket, update in graphed],
        ("slide_window", lambda: vsm.slide_window(win, cov)),
        ("the filter step, graph replay", lambda: est._filter_step(ekf, x)),
        ("ekf_predict", lambda: vekf.ekf_predict(ekf, 0.005, est.ekf_params)),
        ("ekf_update_imu", lambda: vekf.ekf_update_imu(ekf, wa[:3], wa[3:], est._gravity,
                                                      est.ekf_params)),
    ]
    for name, fn in stages:
        slow = name.startswith(("solve_window", "_linearize", "preintegrate", "frontend",
                                "  track", "  optimize", "  the same", "the smoother"))
        ms = call_ms(fn, 3 if slow else N_TIMED)
        kernels = sum(kernel_count(fn, 1).values())
        print(f"[vio stage] {name}: {ms:.3f} ms a call, {kernels:.0f} CUDA kernels "
              f"({1e3 * ms / max(kernels, 1):.1f} us a kernel)")
        if "graph replay" in name or name == "frontend_step":
            busy, top = device_breakdown(fn)
            print(f"[vio stage]   its kernels' device time {busy:.3f} ms ({100 * busy / ms:.1f}% "
                  f"of the call); the longest: " + "; ".join(
                      f"{k[:60]} {t:.3f} ms x{c}" for k, t, c in top))


def phase_state_estimator(dev, smi: str) -> dict:
    """The state estimator on the card (see the module docstring, phase 16);
    returns lk_track's row at the mission's shapes."""
    from ocean_perception_tpu_torch.config.bindings import load_state_estimator_params
    from ocean_perception_tpu_torch.vio import state_estimator as vse
    from ocean_perception_tpu_torch.vio.evaluation import evaluate_trajectory

    parser = YamlParser(node_path=VIO_YAML, shared_path=FARMSIM_YAML)
    params = load_state_estimator_params(parser)
    rig = load_rig(parser)
    cfg = params.smoother
    trk = params.frontend.tracker
    print(f"[vio] {VIO_YAML} on {FARMSIM_YAML}: rig {rig.left.width}x{rig.left.height}, fx "
          f"{rig.left.fx:.3f}, baseline {rig.baseline:.3f}; window {cfg.window}, "
          f"{cfg.iterations} GN iterations, {cfg.max_landmarks} landmark columns, "
          f"{params.max_imu_per_keypose} IMU samples a keypose; tracker capacity {trk.capacity}, "
          f"LK window {trk.lk.window}, max_level {trk.lk.max_level}, max_disp {trk.matcher.max_disp}")
    t0 = time.perf_counter()
    events, gt, n_frames, depth = vio_mission(rig, params.n_gravity)
    print(f"[vio] mission: {VIO_SECONDS:.0f} s, {n_frames} stereo frames, "
          f"{sum(k == 'imu' for k, _ in events)} IMU samples, "
          f"{sum(k == 'depth' for k, _ in events)} depth; plane at {depth:.4f} m "
          f"(disparity {VIO_DISP:g} px); made in {time.perf_counter() - t0:.1f} s")

    est = vse.StateEstimator(params, rig, device=dev)
    est.initialize(gt[0].timestamp, gt[0].world_T_body)
    # The frontend step, the smoother update (with the filter's rewind and
    # replay) and the filter step, each timed by CUDA events around its call.
    events_ms = {}
    est.frontend.track = timed(events_ms, "frontend", est.frontend.track)
    est._run_smoother = timed(events_ms, "smoother", est._run_smoother)
    est._filter_predict_update = timed(events_ms, "filter", est._filter_predict_update)
    slides = [0]
    orig_slide = vse.slide_window

    def counting_slide(*a, **k):
        slides[0] += 1
        return orig_slide(*a, **k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    cuda.reset_launches()
    vse.slide_window = counting_slide
    t0 = time.perf_counter()
    try:
        counted = {}

        def arm(i):
            if i == VIO_WARMUP:
                syncs.armed = True
                counted.update(solves=len(events_ms.get("smoother", [])), slides=slides[0])

        with SyncLog() as syncs:
            solves, modes, statuses, calls = vio_drive(est, events, lk_frame=VIO_LK_FRAME,
                                                       on_frame=arm)
    finally:
        vse.slide_window = orig_slide
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    spans = {name: [start.elapsed_time(end) if isinstance(start, torch.cuda.Event)
                    else 1e3 * (end - start) for start, end in pairs]
             for name, pairs in events_ms.items()}
    n_solves, n_imu = len(solves), len(spans["filter"])
    if launches["lk_track"] != 2 * n_frames or any(
            v for k, v in launches.items() if k != "lk_track"):
        raise AssertionError(f"vio launches {launches}: expected lk_track 2 a frame over "
                             f"{n_frames} frames and nothing else")
    print(f"[vio] {n_frames} frames in {wall:.1f} s ({1e3 * wall / n_frames:.2f} ms a frame of "
          f"host time, IMU and depth included): {est._n_keyposes} keyposes in the window, "
          f"{n_solves} smoother updates, {slides[0]} slides; launches {launches}")
    print(f"[vio] frontend ms a frame (CUDA events, by calls): {percentiles(spans['frontend'])}")
    print(f"[vio] smoother-update ms (preintegration, {cfg.iterations} + 1 linearizations, "
          f"readout, the filter's rewind and replay; CUDA events): "
          f"{percentiles(spans['smoother'])}")
    print(f"[vio] filter-step ms (predict + IMU update, float64; CUDA events) against the "
          f"{VIO_IMU_NS / 1e6:.0f} ms IMU period: {percentiles(spans['filter'])}")
    # Counted from frame VIO_WARMUP on: frames, IMU samples (20 a frame),
    # smoother updates and slides after it.
    n_f, n_i = n_frames - VIO_WARMUP, n_imu - 20 * VIO_WARMUP
    n_s, n_sl = n_solves - counted["solves"], slides[0] - counted["slides"]
    per = dict(frame=syncs.counts.get("frame", 0) / n_f,
               imu=syncs.counts.get("imu", 0) / n_i,
               smoother=syncs.counts.get("smoother", 0) / max(n_s, 1),
               slide=syncs.counts.get("slide", 0) / max(n_sl, 1))
    warm = {k: v for k, v in syncs.counts.items() if k.startswith("warm-up")}
    print(f"[vio] host syncs from frame {VIO_WARMUP} on: {per['frame']:.3f} a frame ({n_f}), "
          f"{per['imu']:.4f} an IMU sample ({n_i}), {per['smoother']:.3f} a smoother update "
          f"({n_s}), {per['slide']:.3f} a slide ({n_sl}); other {syncs.counts.get('other', 0)}; "
          f"in the first {VIO_WARMUP} frames {warm}")
    for (kind, site), n in sorted(syncs.sites.items()):
        print(f"[vio]   {kind}: {n} x {site}")
    print(f"[vio] peak device memory {peak / 2**20:.1f} MiB ({(peak - base_bytes) / 2**20:.1f} "
          f"MiB above the start); {smi}")
    expect = dict(frame=vse.FRAME_SYNCS, imu=vse.IMU_SYNCS, smoother=vse.SMOOTHER_SYNCS,
                  slide=vse.SLIDE_SYNCS)
    for k, v in expect.items():
        if per[k] > v:
            raise AssertionError(f"vio: {per[k]} host syncs a {k}, more than the {v} stated")
    if syncs.counts.get("other", 0):
        raise AssertionError(f"vio: {syncs.counts['other']} host syncs outside the estimator")

    # The state stays on the card.
    for name, t in (*est.window._asdict().items(), *est.ekf_state._asdict().items()):
        if t.device.type != torch.device(dev).type:
            raise AssertionError(f"vio: {name} is on {t.device}")
    if slides[0] < VIO_MIN_SLIDES:
        raise AssertionError(f"vio: the window slid {slides[0]} times")

    # Accuracy against the groundtruth (unaligned, as the mission matrix scores).
    traj = {}
    for t_ns, R, p in solves:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R.double().cpu().numpy(), p.double().cpu().numpy()
        traj[t_ns] = T
    ts = np.array(sorted(traj), np.int64)
    rep = evaluate_trajectory(ts, np.stack([traj[t] for t in ts]), gt, align="none",
                              rpe_deltas_s=[0.5])
    rpe = rep["rpe"].get("0.5s", {})
    finite = all(np.isfinite(T).all() for T in traj.values())
    print(f"[vio] smoother trajectory: {len(ts)} poses, ATE {rep['ate_rmse_m']:.4f} m rmse "
          f"(max {rep['ate_max_m']:.4f}, unaligned), RPE@0.5s {rpe.get('trans_rmse_m', float('nan')):.4f} m, "
          f"{rpe.get('rot_rmse_deg', float('nan')):.4f} deg; vision available after "
          f"{sum(modes)} of {n_frames} frames; statuses {sorted(set(statuses))}")
    if not finite or not rep["ate_rmse_m"] < VIO_MAX_ATE:
        raise AssertionError(f"vio: ATE {rep['ate_rmse_m']} m (bound {VIO_MAX_ATE})")

    # The first frames again on the CPU.
    until = gt[VIO_CPU_FRAMES - 1].timestamp
    cpu = vse.StateEstimator(params, rig, device="cpu")
    cpu.initialize(gt[0].timestamp, gt[0].world_T_body)
    t0 = time.perf_counter()
    c_solves, c_modes, c_statuses, _ = vio_drive(cpu, events, until_ns=until)
    cpu_wall = time.perf_counter() - t0
    g_solves = [s for s in solves if s[0] <= until]
    k = VIO_CPU_FRAMES
    if c_modes != modes[:k] or c_statuses != statuses[:k]:
        raise AssertionError(f"vio CPU parity: modes or statuses differ\n{c_modes}\n{modes[:k]}\n"
                             f"{c_statuses}\n{statuses[:k]}")
    if [s[0] for s in c_solves] != [s[0] for s in g_solves]:
        raise AssertionError("vio CPU parity: the smoother ran at other keyposes")
    dp = max(float((a[2].cpu() - b[2].cpu()).abs().max()) for a, b in zip(c_solves, g_solves))
    dR = max(float((a[1].cpu() - b[1].cpu()).abs().max()) for a, b in zip(c_solves, g_solves))
    print(f"[vio] the first {k} frames on the CPU ({cpu_wall:.1f} s): {len(c_solves)} smoother "
          f"updates at the same keyposes, modes and VO statuses equal, max |p| diff {dp:.3e} m, "
          f"max |R| diff {dR:.3e} (tolerance {VIO_CPU_TOL})")
    if not (dp < VIO_CPU_TOL and dR < VIO_CPU_TOL):
        raise AssertionError(f"vio CPU parity: {dp} m, {dR}")

    vio_stage_times(est, next(m for k, m in reversed(events) if k == "stereo"))
    lk_row = phase_lk_kernels(calls, "vio lk")["lk_track"]
    row = dict(launches=launches["lk_track"], frames=n_frames,
               shapes=f"{rig.left.width}x{rig.left.height}, K={trk.capacity}, "
                      f"{trk.lk.max_level + 1} levels, window {trk.lk.window}",
               **lk_row)
    return row, dict(params=params, rig=rig, events=events, gt=gt, solves=solves,
                     n_frames=n_frames)


VIO_SAVE_SLIDES = 10    # phase 17 (b): the node saves at the first update after this many slides
# Phase 17 (d): the mission fed in real time (at twice real time the vision
# thread is over its budget of a frame period; PERF.md §6), and the bound on
# the longest gap between two filter outputs from frame VIO_WARMUP on: 20 IMU
# periods, about twice the longest seen in runs without a stall. Before the wrapper
# froze the heap, a full garbage collection held both threads for
# 0.85-3.35 s, and the queue of 4 frames dropped a run of them (PERF.md §6).
VIO_THREAD_SPEED = 1.0
VIO_MAX_FILTER_GAP_MS = 100.0
TRI_BEACONS, TRI_MASKED = 8, 5  # phase 17 (e): trilaterate's beacons, and the one masked


def vio_message(kind: str, m):
    """A mission event as the message a sensor driver publishes for it
    (float32 frames as raw images)."""
    if kind == "imu":
        return "sensors/imu", ImuMessage(m.timestamp, m.angular_velocity, m.linear_acceleration)
    if kind == "depth":
        return "sensors/depth", DepthMessage(m.timestamp, m.depth)
    return "sensors/stereo", StereoImageMessage(m.timestamp, m.camera_id,
                                                ImageMessage.from_array(m.timestamp, m.left),
                                                ImageMessage.from_array(m.timestamp, m.right))


def init_pose_message(pose) -> PoseStampedMessage:
    from ocean_perception_tpu_torch.fabric.nodes.state_estimator_node import matrix_quat

    T = pose.world_T_body
    return PoseStampedMessage(timestamp=pose.timestamp,
                              pose=np.concatenate([matrix_quat(T[:3, :3]), T[:3, 3]]))


def vio_ate(tag: str, stamped, gt) -> float:
    """The unaligned ATE (rmse, m) of (t_ns, 4x4 pose) pairs against the
    mission's groundtruth, printed with RPE@0.5 s; fails above VIO_MAX_ATE."""
    from ocean_perception_tpu_torch.vio.evaluation import evaluate_trajectory

    traj = dict(stamped)
    ts = np.array(sorted(traj), np.int64)
    poses = np.stack([traj[t] for t in ts])
    rep = evaluate_trajectory(ts, poses, gt, align="none", rpe_deltas_s=[0.5])
    rpe = rep["rpe"].get("0.5s", {})
    print(f"[{tag}] {len(ts)} smoother poses, ATE {rep['ate_rmse_m']:.4f} m rmse (max "
          f"{rep['ate_max_m']:.4f}, unaligned), RPE@0.5s "
          f"{rpe.get('trans_rmse_m', float('nan')):.4f} m, "
          f"{rpe.get('rot_rmse_deg', float('nan')):.4f} deg")
    if not np.isfinite(poses).all() or not rep["ate_rmse_m"] < VIO_MAX_ATE:
        raise AssertionError(f"{tag}: ATE {rep['ate_rmse_m']} m (bound {VIO_MAX_ATE})")
    return rep["ate_rmse_m"]


def device_poses(solves) -> list:
    """(t_ns, 4x4) of smoother callbacks' (t_ns, R, p) device tensors."""
    out = []
    for t_ns, R, p in solves:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R.double().cpu().numpy(), p.double().cpu().numpy()
        out.append((t_ns, T))
    return out


def require_lk_launches(tag: str, launches: dict, n_frames: int) -> None:
    """A VIO path's launches: lk_track 2 a frame it processed, no other kernel."""
    if launches["lk_track"] != 2 * n_frames or any(
            v for k, v in launches.items() if k != "lk_track"):
        raise AssertionError(f"{tag} launches {launches}: expected lk_track 2 a frame "
                             f"({n_frames} frames) and nothing else")


def check_lk_calls(calls: list, tag: str) -> float:
    """lk_track against lk_track_plain on recorded calls, bit for bit."""
    err = 0.0
    for direction, (_, args, kwargs, _) in zip(("forward", "backward"), calls):
        for a, b in zip(lk.lk_track(*args, **kwargs), lk.lk_track_plain(*args, **kwargs)):
            fa, fb = a.float().nan_to_num(-1e30), b.float().nan_to_num(-1e30)
            require_equal(f"{tag} lk_track {direction}", fa, fb)
            err = max(err, max_abs(fa, fb))
    print(f"[{tag}] lk_track: the {len(calls)} calls of one node frame bit-identical to "
          f"lk_track_plain")
    return err


def phase_vio_node(dev, mission, tmp: Path) -> dict:
    """Phase 17 (a) and (b): the state estimator node over an InProcessBus,
    then a fresh node resumed from its checkpoint."""
    from ocean_perception_tpu_torch.fabric.nodes.state_estimator_node import StateEstimatorNode
    from ocean_perception_tpu_torch.vio import checkpoint as vck
    from ocean_perception_tpu_torch.vio import state_estimator as vse

    events, gt = mission["events"], mission["gt"]
    bus = InProcessBus()
    node = StateEstimatorNode.from_config(bus, VIO_YAML, FARMSIM_YAML, device=dev)
    published = {"vio/pose/filter": 0, "vio/pose/smoother": 0}
    for ch in published:
        bus.subscribe(ch, lambda c, _m: published.__setitem__(c, published[c] + 1))
    est = node.est
    solves, slides, saved, at = [], [0], {}, [0]
    est.smoother_callbacks.append(lambda r: solves.append((est._last_smoother_t_ns, r.R, r.p)))

    def save_once(_r):
        if saved or slides[0] < VIO_SAVE_SLIDES:
            return
        path = tmp / "vio_node.npz"
        t0 = time.perf_counter()
        vck.save_estimator(est, str(path))
        saved.update(ms=1e3 * (time.perf_counter() - t0), bytes=path.stat().st_size, path=path,
                     event=at[0], window=est.window, ekf=est.ekf_state, n_keyposes=est._n_keyposes,
                     ekf_time=est._ekf_time)

    est.smoother_callbacks.append(save_once)
    orig_slide = vse.slide_window

    def counting_slide(*a, **k):
        slides[0] += 1
        return orig_slide(*a, **k)

    frame_ms, frame, calls, counted = [], 0, None, {}
    cuda.reset_launches()
    vse.slide_window = counting_slide
    t_run = time.perf_counter()
    try:
        bus.publish("vio/init_pose", init_pose_message(gt[0]))
        with SyncLog() as syncs:
            for i, (kind, m) in enumerate(events):
                at[0] = i
                ch, msg = vio_message(kind, m)
                if kind != "stereo":
                    bus.publish(ch, msg)
                    continue
                if frame == VIO_WARMUP:
                    syncs.armed = True
                    counted = dict(imu=sum(k == "imu" for k, _ in events[:i]))
                t0 = time.perf_counter()
                if frame == VIO_LK_FRAME:
                    calls = record_lk_calls(lambda: bus.publish(ch, msg))
                else:
                    bus.publish(ch, msg)
                frame_ms.append(1e3 * (time.perf_counter() - t0))
                frame += 1
    finally:
        vse.slide_window = orig_slide
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = dict(cuda.LAUNCHES)
    n_frames = mission["n_frames"]
    require_lk_launches("vio node", launches, n_frames)

    # The same engine, inputs and order as phase 16: the same smoother poses.
    want = mission["solves"]
    if [s[0] for s in solves] != [s[0] for s in want]:
        raise AssertionError("vio node: the smoother ran at other keyposes than phase 16's")
    for (t_ns, R, p), (_, R16, p16) in zip(solves, want):
        require_equal(f"vio node smoother R at {t_ns}", R, R16)
        require_equal(f"vio node smoother p at {t_ns}", p, p16)
    n_imu = sum(k == "imu" for k, _ in events)
    n_f, n_i = n_frames - VIO_WARMUP, n_imu - counted["imu"]
    per_frame = syncs.counts.get("frame", 0) / n_f
    per_imu = syncs.counts.get("imu", 0) / n_i
    print(f"[vio node] StateEstimatorNode.from_config({VIO_YAML}, {FARMSIM_YAML}, device={dev}) "
          f"over an InProcessBus: {n_frames} frames, {n_imu} IMU samples in {wall:.1f} s; "
          f"published {published['vio/pose/filter']} filter and "
          f"{published['vio/pose/smoother']} smoother poses; {len(solves)} smoother poses equal "
          f"phase 16's bit for bit; launches {launches}")
    print(f"[vio node] node ms a frame (publish to return, host clock): {percentiles(frame_ms)}")
    print(f"[vio node] host syncs from frame {VIO_WARMUP} on: {per_frame:.3f} a frame ({n_f}), "
          f"{per_imu:.4f} an IMU sample ({n_i}; a published filter pose is one); by kind "
          f"{syncs.counts}")
    for (kind, site), n in sorted(syncs.sites.items()):
        print(f"[vio node]   {kind}: {n} x {site}")
    if per_frame > vse.FRAME_SYNCS or syncs.counts.get("other", 0):
        raise AssertionError(f"vio node: {per_frame} host syncs a frame, "
                             f"{syncs.counts.get('other', 0)} elsewhere")
    if published["vio/pose/smoother"] != len(solves):
        raise AssertionError(f"vio node: {published['vio/pose/smoother']} smoother poses "
                             f"published for {len(solves)} updates")
    ate = vio_ate("vio node", device_poses(solves), gt)

    # (b) A fresh node resumed from the checkpoint saved after the 10th slide.
    if not saved:
        raise AssertionError(f"vio node: no checkpoint ({slides[0]} slides)")
    bus2 = InProcessBus()
    node2 = StateEstimatorNode.from_config(bus2, VIO_YAML, FARMSIM_YAML, device=dev)
    t0 = time.perf_counter()
    vck.load_estimator(node2.est, str(saved["path"]))
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    node2._init.set()
    for name, a, b in ([("window." + k, v, getattr(saved["window"], k))
                        for k, v in node2.est.window._asdict().items()]
                       + [("ekf." + k, v, getattr(saved["ekf"], k))
                          for k, v in node2.est.ekf_state._asdict().items()]):
        if a.device.type != torch.device(dev).type:
            raise AssertionError(f"vio resume: {name} loaded on {a.device}")
        require_equal(f"vio resume {name}", a, b)
    if (node2.est._n_keyposes, node2.est._ekf_time) != (saved["n_keyposes"], saved["ekf_time"]):
        raise AssertionError("vio resume: counters differ from the saved node's")
    resumed = []
    node2.est.smoother_callbacks.append(
        lambda r: resumed.append((node2.est._last_smoother_t_ns, r.R, r.p)))
    rest = events[saved["event"] + 1:]
    for kind, m in rest:
        bus2.publish(*vio_message(kind, m))
    torch.cuda.synchronize()
    print(f"[vio resume] save_estimator after slide {VIO_SAVE_SLIDES} (at "
          f"{events[saved['event']][1].timestamp * 1e-9:.2f} s of the mission): "
          f"{saved['ms']:.3f} ms, {saved['bytes']} bytes; load_estimator {load_ms:.3f} ms, window "
          f"and EKF equal the saved ones bit for bit, every tensor on the card; then "
          f"{sum(k == 'stereo' for k, _ in rest)} more frames")
    resumed_ate = vio_ate("vio resume", device_poses(resumed), gt)
    return dict(lk_calls=calls, ate=ate, resumed_ate=resumed_ate,
                lk_track=dict(launches=launches["lk_track"], frames=n_frames,
                              max_abs_err=check_lk_calls(calls, "vio node")))


def phase_vio_player(dev, mission, tmp: Path) -> None:
    """Phase 17 (c): the mission as an LCM log, played by dataset_player."""
    from ocean_perception_tpu_torch.fabric.lcm_log import LcmLogWriter
    from ocean_perception_tpu_torch.fabric.lcm_wire import to_lcm
    from ocean_perception_tpu_torch.fabric.nodes import dataset_player

    events, gt = mission["events"], mission["gt"]
    path = tmp / "vio_mission.lcmlog"
    t0 = time.perf_counter()
    with LcmLogWriter(str(path)) as w:
        for ch, msg in [("vio/init_pose", init_pose_message(gt[0]))] + [
                vio_message(k, m) for k, m in events]:
            sd, v = to_lcm(msg)
            w.write(ch, sd.encode(v), timestamp_us=msg.timestamp // 1000)
    write_s = time.perf_counter() - t0
    bus = InProcessBus()
    frames = []
    bus.subscribe("vio/pose/filter", lambda _c, m: frames.append(m.timestamp))
    frames_seen = [0]

    def arm(_c, _m):
        frames_seen[0] += 1
        syncs.armed = frames_seen[0] >= VIO_WARMUP

    bus.subscribe("vio/pose/filter", arm)
    cuda.reset_launches()
    t0 = time.perf_counter()
    with SyncLog() as syncs:
        traj = dataset_player.run("lcmlog", str(path), rig=mission["rig"],
                                  params=mission["params"], speed=0.0, bus=bus, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    n_frames = mission["n_frames"]
    if len(frames) != n_frames:
        raise AssertionError(f"vio player: {len(frames)} frames played of {n_frames} written")
    require_lk_launches("vio player", launches, n_frames)
    n_f = n_frames - VIO_WARMUP
    print(f"[vio player] {path.name}: {path.stat().st_size / 2**20:.1f} MiB written in "
          f"{write_s:.1f} s (frames as 8-bit image_t); dataset_player.run('lcmlog', device={dev}) "
          f"at speed 0: {len(frames)} frames of {n_frames} in {wall:.1f} s, "
          f"{len(frames) / wall:.2f} frames/s; host syncs a frame after {VIO_WARMUP}: "
          f"{syncs.counts.get('frame', 0) / n_f:.3f} (the engine's {1} and the player's "
          f"filter pose; by kind {syncs.counts}); launches {launches}")
    vio_ate("vio player", [(s.timestamp, s.world_T_body) for s in traj], gt)
    return dict(launches=launches["lk_track"], frames=n_frames)


def longest_gaps(done: np.ndarray, spans: list) -> list:
    """For each (start, end) span, the longest gap between consecutive times
    of done (sorted) from the last one before it to the first one after."""
    gaps = []
    for t0, t1 in spans:
        before, inside, after = done[done < t0], done[(done >= t0) & (done <= t1)], done[done > t1]
        span = np.concatenate([before[-1:], inside, after[:1]])
        if span.size >= 2:
            gaps.append(float(np.diff(span).max()))
    return gaps


def phase_vio_threaded(dev, mission) -> dict:
    """Phase 17 (d): ThreadedStateEstimator, with its default stereo queue,
    fed the mission at VIO_THREAD_SPEED times real time. A filter output is a filter step's
    state complete on the card: a CUDA event recorded on the filter
    thread's stream after each step (no read-back, which would add a sync
    a step); a smoother update in flight spans the events recorded on the
    vision thread's stream before and after it. Times are the events' on
    the card's clock."""
    from ocean_perception_tpu_torch.vio.threaded_estimator import ThreadedStateEstimator

    events, gt = mission["events"], mission["gt"]
    speed = VIO_THREAD_SPEED
    cuda.reset_launches()
    te = ThreadedStateEstimator(mission["params"], mission["rig"], device=dev)
    queue = inspect.signature(ThreadedStateEstimator).parameters["stereo_queue_size"].default
    core = te.core
    errors, frames_in = [], [0]

    def recording(name, fn):
        def call(*a, **k):
            try:
                return fn(*a, **k)
            except BaseException:
                errors.append((name, traceback.format_exc()))
                raise
        return call

    for name in ("receive_stereo", "receive_imu", "receive_depth", "_maybe_imu_keypose",
                 "poll_imu_keypose"):
        setattr(core, name, recording(name, getattr(core, name)))
    stereo = core.receive_stereo
    core.receive_stereo = lambda m: (frames_in.__setitem__(0, frames_in[0] + 1), stereo(m))[1]
    outputs, updates, steps, host_done, host_updates = [], [], [], [], []
    run_smoother, filter_step = core._run_smoother, core._filter_predict_update

    def marker():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def timed_update(*a):
        start, t0 = marker(), time.perf_counter()
        run_smoother(*a)
        updates.append((start, marker()))
        host_updates.append((t0, time.perf_counter()))

    def timed_step(*a):
        t0 = time.perf_counter()
        filter_step(*a)
        outputs.append(marker())
        host_done.append(time.perf_counter())
        steps.append(1e3 * (host_done[-1] - t0))

    core._run_smoother, core._filter_predict_update = timed_update, timed_step
    solves = []
    te.smoother_callbacks.append(lambda r: solves.append((core._last_smoother_t_ns, r.R, r.p)))
    te.initialize(gt[0].timestamp, gt[0].world_T_body)
    # The interpreter's garbage collections while the threads run: (gen, s).
    collections, gc_start = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            collections.append((info["generation"], time.perf_counter() - gc_start[0]))

    base = marker()
    t_wall0, t_ns0 = time.perf_counter(), events[0][1].timestamp
    feed = {"imu": te.receive_imu, "depth": te.receive_depth, "stereo": te.receive_stereo}
    gc.callbacks.append(on_gc)
    try:
        for kind, m in events:
            delay = (m.timestamp - t_ns0) * 1e-9 / speed - (time.perf_counter() - t_wall0)
            if delay > 0:
                time.sleep(delay)
            feed[kind](m)
        fed_s = time.perf_counter() - t_wall0
        idle = te.wait_idle(timeout=300)
    finally:
        gc.callbacks.remove(on_gc)
        te.shutdown()
    torch.cuda.synchronize()
    drained_s = time.perf_counter() - t_wall0
    launches = dict(cuda.LAUNCHES)
    if errors or not idle:
        raise AssertionError(f"vio threaded: idle {idle}, {len(errors)} worker exceptions:\n"
                             + "\n".join(f"{n}: {tb}" for n, tb in errors[:3]))
    done = np.array([base.elapsed_time(ev) for ev in outputs])
    spans = [(base.elapsed_time(a), base.elapsed_time(b)) for a, b in updates]
    gaps = longest_gaps(done, spans)
    # The same on the host's clock: the filter thread's calls returning.
    host_gaps = longest_gaps(1e3 * np.asarray(host_done),
                             [(1e3 * a, 1e3 * b) for a, b in host_updates])
    n_frames, n_imu = mission["n_frames"], sum(k == "imu" for k, _ in events)
    print(f"[vio threaded] ThreadedStateEstimator(device={dev}), the mission fed at "
          f"{speed:g}x real time: fed in {fed_s:.1f} s, drained in {drained_s:.1f} s; "
          f"the vision thread took {frames_in[0]} of {n_frames} frames (its queue of {queue} drops "
          f"the oldest), {len(spans)} smoother updates; {len(outputs)} filter steps of {n_imu} IMU "
          f"samples; no worker exception; launches {launches}")
    print(f"[vio threaded] filter step ms (host clock, the filter thread's call): "
          f"{percentiles(steps)}; between consecutive filter outputs on the card: "
          f"{percentiles(np.diff(done))}")
    if gaps:
        print(f"[vio threaded] the longest gap between two filter outputs while a smoother "
              f"update is in flight: {max(gaps):.3f} ms (median over the {len(gaps)} updates "
              f"{statistics.median(gaps):.3f} ms) against the {VIO_IMU_NS / 1e6:.0f} ms IMU "
              f"period ({VIO_IMU_NS / 1e6 / speed:g} ms of wall time at "
              f"{speed:g}x); update ms on the card "
              f"{percentiles([b - a for a, b in spans])}; on the host's clock, the longest gap "
              f"between two filter calls returning while an update runs {max(host_gaps):.3f} ms "
              f"(median {statistics.median(host_gaps):.3f})")
    by_gen = {g: [t for gg, t in collections if gg == g] for g in range(3)}
    print(f"[vio threaded] garbage collections while the threads ran (heap frozen at their "
          f"start): " + ", ".join(f"generation {g} {len(t)}, longest {1e3 * max(t, default=0):.3f} ms"
                                  for g, t in by_gen.items()))
    # From the IMU sample before frame VIO_WARMUP on: each thread's first
    # frames make its one-time CUDA set-up (handles, first launches).
    frame_at = [i for i, (k, _) in enumerate(events) if k == "stereo"]
    warm = sum(k == "imu" for k, _ in events[:frame_at[VIO_WARMUP]])
    gaps_all = np.diff(done)
    at = int(gaps_all.argmax())
    longest = float(gaps_all[warm:].max())
    print(f"[vio threaded] the longest gap between two filter outputs: {gaps_all[at]:.3f} ms "
          f"after filter output {at} ({at * VIO_IMU_NS * 1e-9:.2f} s into the mission); from frame "
          f"{VIO_WARMUP} on {longest:.3f} ms (bound {VIO_MAX_FILTER_GAP_MS:g} ms)")
    if longest > VIO_MAX_FILTER_GAP_MS:
        raise AssertionError(f"vio threaded: the filter stopped for {longest:.3f} ms "
                             f"(bound {VIO_MAX_FILTER_GAP_MS} ms)")
    require_lk_launches("vio threaded", launches, frames_in[0])
    if len(solves) < 2:
        raise AssertionError(f"vio threaded: {len(solves)} smoother updates")
    vio_ate("vio threaded", device_poses(solves), gt)
    return dict(launches=launches["lk_track"], frames=frames_in[0])


def phase_trilateration(dev) -> dict:
    """Phase 17 (e): trilaterate on the card in float64 and float32 (8
    beacons, one masked): its lm_solve_small and lm_row_sum launches against
    their twins, bit for bit, with their times beside torch.linalg.solve_ex
    and torch.sum (phase_lm_kernels), and the fix against the CPU's."""
    from ocean_perception_tpu_torch.vio.trilateration import trilaterate

    rng = np.random.default_rng(8)
    p_true = np.array([3.0, -4.0, -12.0])
    beacons = rng.uniform(-50, 50, (TRI_BEACONS, 3))
    ranges = np.linalg.norm(beacons - p_true, axis=1) + rng.normal(0, 0.01, TRI_BEACONS)
    mask = np.ones(TRI_BEACONS, bool)
    mask[TRI_MASKED] = False
    ranges[TRI_MASKED] = 1e3  # a masked outlier must not move the fix
    rows = {"lm_solve_small": {}, "lm_row_sum": {}}
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        args = [torch.as_tensor(beacons, dtype=dtype), torch.as_tensor(ranges, dtype=dtype),
                torch.full((TRI_BEACONS,), 0.01, dtype=dtype), torch.as_tensor(mask)]
        on_card = [a.to(dev) for a in args]
        out = []
        cuda.reset_launches()
        calls = record_lm_calls(lambda: out.append(trilaterate(*on_card)))
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        res, cpu = out[0], trilaterate(*args)
        dp = float((res.position.cpu() - cpu.position).abs().max())
        err = float(np.abs(res.position.double().cpu().numpy() - p_true).max())
        print(f"[trilaterate {str(dtype)[6:]}] {TRI_BEACONS} beacons, beacon {TRI_MASKED} masked: "
              f"launches {launches}; fix {err:.4f} m from the truth, success "
              f"{bool(res.success)}; card vs CPU max |position diff| {dp:.3e} (tolerance {tol})")
        if not (bool(res.success) and err < 0.1 and dp < tol
                and res.position.dtype == dtype
                and res.position.device.type == torch.device(dev).type):
            raise AssertionError(f"trilaterate {dtype}: fix {err}, card vs CPU {dp}")
        if launches["lm_solve_small"] != 20 or launches["lm_row_sum"] != 22:
            raise AssertionError(f"trilaterate {dtype}: launches {launches}")
        for name, row in phase_lm_kernels(calls, f" trilaterate {str(dtype)[6:]}").items():
            rows[name][str(dtype)[6:]] = dict(launches=launches[name], **row)
    return rows


def phase_vio_deploy(dev, mission) -> dict:
    """Phase 17: the VIO deployment at the shipped config's full size, on
    phase 16's mission (see the module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        node = phase_vio_node(dev, mission, Path(tmp))
        player = phase_vio_player(dev, mission, Path(tmp))
    threaded = phase_vio_threaded(dev, mission)
    return dict(lk_track=dict(node=node["lk_track"], player=player, threaded=threaded),
                trilaterate=phase_trilateration(dev))


SHARD_BLOCKS = (2, 4)  # phase 18's block counts, each mesh one card's cuda:0 repeated
SHARD_FRAMES = 3       # frames timed by calls, each configuration of phase 18
SHARD_ENTRIES = 2      # phase 18's camera split: N_CAMERAS cameras over this many mesh entries
PASS_KINDS = {("1", "true"): "R+ (refresh)", ("1", "false"): "R-", ("0", "false"): "C+/C-",
              ("0", "true"): "last C- (mask)"}
TRACE_DIR = cuda._BUILD / "sharded_trace"  # git-ignored, beside the kernels' build


def record_block_passes(fn) -> tuple:
    """fn() with every pass the sharded match launches recorded: (fn's
    result, [(block_pass arguments, outputs)])."""
    calls = []
    inner = stereo_sharded.block_pass

    def recorded(*args):
        out = inner(*args)
        calls.append((args, out))
        return out

    stereo_sharded.block_pass = recorded
    try:
        result = fn()
    finally:
        stereo_sharded.block_pass = inner
    torch.cuda.synchronize()
    return result, calls


def pass_bytes(args) -> float:
    """The least bytes one pm_pass must move: the fronts it reads (and the
    noise rows of a refresh) and writes, and one volume element for each
    distinct pixel its walk steps on within the loop bounds (every pixel of
    the block for a refresh's lookups and a mask's cost(0))."""
    C, _, _, _, _, axis, fold, block, p = args[:9]
    H, W, e, pr = block.n_rows, C.shape[1], C.element_size(), p.patch_radius
    chunk, row0 = block.chunk, block.row0
    written = chunk * W * (4 if axis == 0 and fold else 4 + e)
    if axis == 1:
        read = chunk * W * (4 + (4 if fold else e))
        rows = sum(pr <= y <= H - pr - 1 for y in range(row0, row0 + chunk))
        pixels = rows * max(0, W - 2 * pr - 1)
    else:
        first, end = max(row0 - p.halo, 0) - 1, min(row0 + chunk + p.halo, H - 1) + 1
        read = (min(end, H) - max(first, 0)) * W * (4 + e)
        lo, hi = max(row0 - p.halo, pr), min(row0 + chunk + p.halo, H - pr - 1)
        pixels = max(0, hi - lo) * max(0, W - 2 * pr)
    if fold:
        pixels = max(pixels, chunk * W)
    return read + written + pixels * e


def line_bytes(args) -> float:
    """The volume lines one pm_pass's walks read: the D costs of every step
    of every scan line, a column of the block's strip (chunk + 2 halo steps)
    or a row of an x-strip (its chunk + 2 halo steps)."""
    C, _, _, _, _, axis, _, block, p = args[:9]
    W, line = C.shape[1], C.shape[2] * C.element_size()
    if axis == 0:
        return (block.chunk + 2 * p.halo) * W * line
    chunks = pm._effective_chunks(W, p.chunks)
    return block.chunk * chunks * (W // chunks + 2 * p.halo) * line


def adversarial_block_args(args, inputs: str) -> tuple:
    """A recorded pm_pass's arguments with adversarial inputs of the same
    shapes: fronts from adversarial_seed (each cost the volume's at its
    disparity, as after any pass) and its noise, on the pass's volume
    ("adversarial seed") or on a tie_volume of its shape ("tie volume")."""
    C, disp, _, noise, direction, axis, fold, block, p = args[:9]
    if inputs == "tie volume":
        C = tie_volume(tuple(C.shape), C.dtype, C.device)
    d, nz = adversarial_seed(tuple(disp.shape), C.shape[2], C.device)
    at = block.front_row0 - block.vol_row0
    cost = pm._full_cost_map(C[at:at + d.shape[0]], d, p.patch_radius)
    return (C, d, cost, None if noise is None else nz[:block.chunk], direction, axis, fold,
            block, p, *args[9:])


def check_block_passes(calls: list, tag: str) -> dict:
    """Each recorded pm_pass against its twin on the same inputs on the card
    (bit-identical), then on adversarial inputs of the same shapes
    (adversarial_block_args); the twin's mean time a pass; the passes' mean
    bound and the lines their walks read."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain = [pm._block_pass_plain(*args) for args, _ in calls]
    end.record()
    end.synchronize()
    err = 0.0
    for (args, ours), ref in zip(calls, plain):
        for a, b in zip(ours, ref):
            if (a is None) != (b is None):
                raise AssertionError(f"{tag}: pm_pass and its twin return different outputs")
            if a is not None:
                require_equal(f"{tag} pm_pass (axis {args[5]}, rows {args[7].row0}+)", a, b)
                err = max(err, max_abs(a, b))
    for inputs in ("adversarial seed", "tie volume"):
        kept = []
        for args, _ in calls:
            adv = adversarial_block_args(args, inputs)
            ours, ref = pm.block_pass(*adv), pm._block_pass_plain(*adv)
            for a, b in zip(ours, ref):
                if (a is None) != (b is None) or (a is not None and not same_bits(a, b)):
                    raise AssertionError(f"{tag} {inputs}: pm_pass (axis {args[5]}, fold "
                                         f"{args[6]}, rows {args[7].row0}+) differs from its twin")
            if args[5] == 0 and args[6]:
                kept.append(float((ours[0] > 0).float().mean()))
        print(f"[sharded {tag}] pm_pass equals its twin bit for bit on the {inputs} at every "
              f"pass of a frame; the masked passes keep {min(kept):.3f}-{max(kept):.3f} of their "
              f"pixels")
    nbytes = statistics.mean(pass_bytes(args) for args, _ in calls)
    lines = statistics.mean(line_bytes(args) for args, _ in calls)
    # One Python call of each kind of pass (the first of each), the host's
    # enqueue included; the mean over the kinds.
    kinds = {(args[5], args[6]): args for args, _ in reversed(calls)}
    call = statistics.mean(call_ms(lambda a=args: pm.block_pass(*a)) for args in kinds.values())
    return dict(max_abs_err=err, call_ms=call, plain_ms=start.elapsed_time(end) / len(calls),
                bytes=nbytes, line_bytes=lines, **bound(nbytes))


def pass_device_times(fn, tag: str) -> dict:
    """pm_pass's device time a launch over one call of fn(), by the
    profiler (utils/profiling.trace; the trace goes to TRACE_DIR), by kind
    of pass; the call's device time, summed over every kernel and copy and
    as their union on the card's clock (busy), with the names that took
    most; and the block regions the call named (Queue.run)."""
    fn()
    torch.cuda.synchronize()
    with profiling.trace(str(TRACE_DIR / tag.replace(" ", "_"))) as prof:
        fn()
        torch.cuda.synchronize()
    def on_card(e, name):  # a kernel or a copy; not a region's range on the card's timeline
        return (e.device_type == DeviceType.CUDA and not name.startswith("block ")
                and not getattr(e, "is_user_annotation", False))

    kinds, total, count, regions, device, names = {}, 0.0, 0, 0, 0.0, {}
    for e in prof.key_averages():
        if e.key.startswith("block "):
            regions += e.count
        if on_card(e, e.key):
            device += e.device_time_total
            names[e.key] = (e.device_time_total, e.count)
        if e.device_type != DeviceType.CUDA or launch_name(e.key) != "pm_pass":
            continue
        m = re.search(r"pm_pass_kernel<[^,]+, (\d), (true|false)[,>]", e.key)
        kind = PASS_KINDS[m.groups()] if m else e.key
        k_total, k_count = kinds.get(kind, (0.0, 0))
        kinds[kind] = (k_total + e.device_time_total, k_count + e.count)
        total += e.device_time_total
        count += e.count
    print(f"[sharded {tag}] pm_pass by profiler: "
          + ("not measured" if count == 0 else
             f"{total / count:.2f} us a launch over {count} launches; "
             + ", ".join(f"{k} {t / c:.2f} us x{c}" for k, (t, c) in kinds.items()))
          + f"; {regions} named block regions in the trace")
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if on_card(e, e.name))
    busy, reach = 0.0, float("-inf")
    for start, end in spans:  # the union of the intervals
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:4]
    print(f"[sharded {tag}] the call's device time: {device / 1e3:.3f} ms summed over "
          f"{len(spans)} kernels and copies, {busy / 1e3:.3f} ms busy (their union); most in "
          + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms x{c}" for k, (v, c) in top))
    return dict(profiler_ms=total / count / 1e3 if count else "not measured", profiled=count,
                call_device_ms=device / 1e3 if device else "not measured",
                call_busy_ms=busy / 1e3 if spans else "not measured")


def phase_sharded(canvas, rig, config, dev) -> dict:
    """Phase 18: one frame across several devices, each played by this card
    (see the module docstring); returns pm_pass's row."""
    print("[sharded] one card stands in for N devices: every mesh entry is cuda:0, each with a "
          "stream of its own, so the blocks' exchanges are ordered by events between streams of "
          "one card; a copy between two cards, and an event wait across them, is not exercised "
          "by this run")
    left_np, right_np = make_inputs(canvas)
    left = torch.as_tensor(left_np, device=dev)
    right = torch.as_tensor(right_np, device=dev)
    gray_l, gray_r = to_grayscale(left), to_grayscale(right)
    for _ in range(SCALE.bit_length() - 1):
        gray_l, gray_r = pyr_down(gray_l), pyr_down(gray_r)
    pmp = pm.PatchMatchParams(max_disp=MAX_DISP // SCALE, chunks=config.chunks, right_wta=True,
                              volume_bf16=True)
    nudged = enhance_underwater(left * np.float32(1 + 2.0**-23),
                                perception_step(left, right, rig, config, dev).depth,
                                config.enhance)[0]
    row = None
    for n in SHARD_BLOCKS:
        mesh = make_mesh(axis_names=("strip",), devices=[dev] * n)
        single_cfg = dataclasses.replace(config, chunks_y=n)
        per_frame = {"cost_volume": n, "pm_pass": 4 * pmp.iters * n, **PER_ENHANCE}

        # The match alone: its passes against their twins, then against pm_match.
        ours, calls = record_block_passes(lambda: sharded_patchmatch(gray_l, gray_r, mesh, pmp))
        checked = check_block_passes(calls, f"N={n}")
        ref = pm.patchmatch_disparity(gray_l, gray_r, dataclasses.replace(pmp, chunks_y=n))
        for f in ref._fields:
            require_equal(f"sharded_patchmatch N={n} {f} vs chunks_y={n}", getattr(ours, f),
                          getattr(ref, f))
        cuda.reset_launches()
        sharded_patchmatch(gray_l, gray_r, mesh, pmp)
        torch.cuda.synchronize()
        require_launches(f"sharded_patchmatch N={n}", dict(cuda.LAUNCHES),
                         {"cost_volume": n, "pm_pass": 4 * pmp.iters * n}, 1)

        # The whole step: the main path of this phase.
        single = perception_step(left, right, rig, single_cfg, dev)
        sharded_perception_step(left, right, rig, config, mesh)  # warm-up
        torch.cuda.synchronize()
        cuda.reset_launches()
        out = sharded_perception_step(left, right, rig, config, mesh)
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        require_launches(f"sharded_perception_step N={n}", launches, per_frame, 1)
        check_fits(f"sharded N={n}", record_fit_calls(
            lambda: sharded_perception_step(left, right, rig, config, mesh)))
        if out.disparity.shape != (H, W) or out.enhanced_left.shape != (H, W, 3) \
                or not all(bool(torch.isfinite(t).all()) for t in out):
            raise AssertionError(f"sharded_perception_step N={n}: bad shapes or non-finite outputs")
        require_equal(f"sharded_perception_step N={n} disparity", out.disparity, single.disparity)
        require_equal(f"sharded_perception_step N={n} depth", out.depth, single.depth)
        line = require_enhance_close(f"sharded N={n}", out.enhanced_left, single.enhanced_left,
                                     nudged)
        same = torch.equal(out.enhanced_left, single.enhanced_left)
        med, frac = accuracy(out.disparity)
        if not (med < 1.0 and frac > 0.5):
            raise AssertionError(f"sharded N={n}: median |disp - {TRUE_DISP}| {med:.4f} px, "
                                 f"valid {frac:.4f}")
        times = pass_device_times(lambda: sharded_patchmatch(gray_l, gray_r, mesh, pmp),
                                  f"N={n}")
        frame = dict(
            sharded_step=call_ms(lambda: sharded_perception_step(left, right, rig, config, mesh),
                                 SHARD_FRAMES),
            single_step=call_ms(lambda: perception_step(left, right, rig, single_cfg, dev),
                                SHARD_FRAMES),
            sharded_match=call_ms(lambda: sharded_patchmatch(gray_l, gray_r, mesh, pmp),
                                  SHARD_FRAMES),
            single_match=call_ms(lambda: pm.patchmatch_disparity(
                gray_l, gray_r, dataclasses.replace(pmp, chunks_y=n)), SHARD_FRAMES))
        print(f"[sharded N={n}] {n} blocks of {H // SCALE // n} internal rows on [cuda:0] x {n}: "
              f"launches {launches}; disparity and depth equal perception_step with chunks_y={n} "
              f"bit for bit; enhanced image {'bit-identical' if same else 'within tolerance'} "
              f"({line}); valid {frac:.4f}, median |d - {TRUE_DISP}| {med:.4f} px; pm_pass "
              f"equals its twin on all {len(calls)} passes of a frame (call "
              f"{checked['call_ms'] * 1e3:.1f} us, plain {checked['plain_ms']:.3f} ms a pass, bound {checked['bound_ms'] * 1e3:.3f} us, "
              f"{checked['bytes'] / 1e6:.3f} MB a pass; the walks' lines "
              f"{checked['line_bytes'] / 1e6:.3f} MB a pass, "
              f"{checked['line_bytes'] / PEAK_BYTES_PER_S * 1e6:.3f} us at 3.35 TB/s); ms a frame "
              f"by calls: sharded step {frame['sharded_step']:.3f} against "
              f"{frame['single_step']:.3f} single (chunks_y={n}), sharded match "
              f"{frame['sharded_match']:.3f} against {frame['single_match']:.3f} single; the "
              f"sharded match's device time {fmt_ms(times['call_device_ms'])} summed, "
              f"{fmt_ms(times['call_busy_ms'])} busy (profiler, every kernel and copy of one "
              f"call)")
        row = dict(launches=launches["pm_pass"], max_abs_err=checked["max_abs_err"],
                   ms=times["profiler_ms"], device_ms=times["profiler_ms"],
                   device_method="profiler", call_ms=checked["call_ms"],
                   plain_ms=checked["plain_ms"],
                   bound_ms=checked["bound_ms"], bound_by=checked["bound_by"],
                   blocks=n, frame_ms=frame, **({"n2": row} if row is not None else {}))

    # The camera split: N_CAMERAS cameras over SHARD_ENTRIES entries of one card.
    cams = make_mesh(axis_names=("cam",), devices=[dev] * SHARD_ENTRIES)
    pairs = [make_inputs(canvas, i) for i in range(N_CAMERAS)]
    bl = torch.as_tensor(np.stack([l for l, _ in pairs]), device=dev)
    br = torch.as_tensor(np.stack([r for _, r in pairs]), device=dev)
    out, stats = multi_camera_step(bl, br, rig, config, mesh=cams)
    ref, ref_stats = multi_camera_step(bl, br, rig, config, device=dev)
    for f in ("disparity", "depth"):
        require_equal(f"camera split {f}", getattr(out, f), getattr(ref, f))
    for f in stats._fields:
        require_equal(f"camera split FleetStats.{f}", getattr(stats, f), getattr(ref_stats, f))
    same = torch.equal(out.enhanced_left, ref.enhanced_left)
    if not same:
        for b in range(N_CAMERAS):
            require_enhance_close(f"camera split camera {b}", out.enhanced_left[b],
                                  ref.enhanced_left[b], nudged)
    split_ms = call_ms(lambda: multi_camera_step(bl, br, rig, config, mesh=cams), SHARD_FRAMES)
    one_ms = call_ms(lambda: multi_camera_step(bl, br, rig, config, device=dev), SHARD_FRAMES)
    print(f"[sharded cameras] multi_camera_step, {N_CAMERAS} cameras over {SHARD_ENTRIES} entries "
          f"of cuda:0: disparity, depth and FleetStats equal the one-card call bit for bit, "
          f"enhanced {'bit-identical' if same else 'within tolerance'}; {split_ms:.3f} ms a call "
          f"against {one_ms:.3f} one card")

    fcfg = dataclasses.replace(config, internal_scale=FARM_SCALE)
    params = ObjectMesherDeviceParams()
    frames = [tuple(torch.as_tensor(np.stack(side), device=dev) for side in
                    zip(*[make_mono_u8(canvas, i + FLEET_PHASE * b) for b in range(N_CAMERAS)]))
              for i in range(3)]
    results = []
    for mesh in (cams, None):
        state, graph = create_fleet_frontend_state(N_CAMERAS, params, image_shape=(H, W),
                                                   device=dev)
        prev = to_grayscale(prepare_frames(frames[0][0], dev))
        for left_u8, right_u8 in frames:
            fe, prev = multi_camera_frontend_step(state, graph, prev, left_u8, right_u8, rig,
                                                  fcfg, params, device=dev, mesh=mesh)
            state, graph = fe.tracker_state, fe.graph
        results.append(_tensors((fe, prev)))
    torch.cuda.synchronize()
    exact = far = 0
    for a, b in zip(*results):
        if torch.equal(a, b):
            exact += 1
        elif a.is_floating_point() and max_abs(a, b) <= 1e-3:
            far += 1
        else:
            raise AssertionError(f"camera split frontend: an output of {tuple(a.shape)} differs "
                                 f"from the one-card call's by {max_abs(a, b)}")
    print(f"[sharded cameras] multi_camera_frontend_step, {N_CAMERAS} cameras over "
          f"{SHARD_ENTRIES} entries of cuda:0, 3 frames at the farm point: {exact} of "
          f"{len(results[0])} outputs bit-identical to the one-card call, {far} within 1e-3")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip([dev] * 4)
    print("[sharded dryrun] " + " | ".join(buf.getvalue().strip().splitlines()))
    return row


FIDUCIAL_YAML = "config/nodes/FiducialLocalizerNode.yaml"
FID_FRAMES = 20            # phase 19 (a): stereo frames, each past the node's rate gate
FID_PERIOD_NS = 600_000_000
FID_NOISE = 0.01           # rendered frames' pixel noise
FID_MAX_T, FID_MAX_R = 0.05, 0.05  # m, rad: a fix against the rendered truth
FID_CPU_TOL = 1e-3         # m and rad: a fix against the CPU's solve on the same detections
FID_FAR = 2.5              # m: the 2-tag map's known weakness, printed, not bounded
FID_IMU_BIAS = np.array([0.15, -0.1, 0.0])  # phase 19 (b): m/s^2, 2 s at rest at 100 Hz
FID_MAX_SNAP = 0.02        # m: the snapped filter position against the truth


def render_tags(tag_map: dict, tag_size: float, cam_T_world: np.ndarray, cam, noise: float,
                seed: int) -> np.ndarray:
    """A float32 frame of the tags (white quiet zone included) on a white
    ground, ray-cast through the pinhole ``cam``: each pixel's ray meets the
    tag's plane, the hit is looked up in ``render_tag``'s pattern."""
    from ocean_perception_tpu_torch.tracking.apriltags import TagFamily, render_tag

    fam = TagFamily.create("tag36h11")
    ys, xs = np.mgrid[0:cam.height, 0:cam.width]
    rays = np.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy, np.ones(xs.shape)], -1)
    img = np.ones((cam.height, cam.width))
    for tag_id, world_T_tag in tag_map.items():
        pat = render_tag(fam, tag_id, cell_px=1, white_border=2)
        cell = tag_size / (fam.dim + 2)
        half = pat.shape[0] / 2.0 * cell
        tag_T_cam = np.linalg.inv(cam_T_world @ world_T_tag)
        o, d = tag_T_cam[:3, 3], rays @ tag_T_cam[:3, :3].T  # in the tag's frame
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = -o[2] / d[..., 2]
        u, v = o[0] + lam * d[..., 0], o[1] + lam * d[..., 1]
        px, py = (u + half) / cell, (half - v) / cell
        inside = (px >= 0) & (px < pat.shape[1]) & (py >= 0) & (py < pat.shape[0]) & (lam > 0)
        img = np.minimum(img, np.where(inside, pat[np.clip(py, 0, pat.shape[0] - 1).astype(int),
                                                   np.clip(px, 0, pat.shape[1] - 1).astype(int)],
                                       1.0))
    rng = np.random.default_rng(seed)
    return np.clip(img + rng.normal(0, noise, img.shape), 0, 1).astype(np.float32)


def look_down(center, tilt: float = 0.0) -> np.ndarray:
    """cam_T_world of a camera at ``center`` looking down the world's -z (the
    tags' +z), its x along the world's x, tilted by ``tilt`` rad about its
    y (across the line of the two shipped tags: a tilt about that line
    trades against a shift across it, which two tags on a line resolve
    poorly, JAX's node alike)."""
    c, s = np.cos(tilt), np.sin(tilt)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ np.diag([1.0, -1.0, -1.0])
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, -R @ np.asarray(center, np.float64)
    return T


def pose_errors(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(translation m, rotation rad) between two 4x4 poses; the angle from
    both the sine and the cosine of the relative rotation, so float32-made
    rotations do not lose it to arccos near 1."""
    R = a[:3, :3].T @ b[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    return (float(np.linalg.norm(a[:3, 3] - b[:3, 3])),
            float(np.arctan2(np.linalg.norm(w), (np.trace(R) - 1.0) / 2.0)))


def fix_matrix(m: PoseStampedMessage) -> np.ndarray:
    from ocean_perception_tpu_torch.fabric.nodes.state_estimator_node import pose_matrix

    return pose_matrix(m.pose)


def phase_fiducial(dev, smi: str) -> None:
    """Fiducial relocalization on the card (see the module docstring, phase 19)."""
    import ocean_perception_tpu_torch.fabric.nodes.fiducial_localizer_node as fln
    from ocean_perception_tpu_torch.config.bindings import load_state_estimator_params
    from ocean_perception_tpu_torch.fabric.nodes.state_estimator_node import StateEstimatorNode
    from ocean_perception_tpu_torch.ops.graphs import GraphedStep
    from ocean_perception_tpu_torch.tracking.apriltags import estimate_camera_pose

    # (a) the shipped deployment on an InProcessBus.
    bus = InProcessBus()
    node = fln.from_config(bus, FIDUCIAL_YAML, FARMSIM_YAML, device=dev)
    cam = load_rig(YamlParser(node_path=FIDUCIAL_YAML, shared_path=FARMSIM_YAML)).left
    fixes = []
    bus.subscribe(node.channel_output, lambda _c, m: fixes.append(m))
    detect_ms, solve_ev, dets = [], [], []

    def detect(*a, **k):
        t0 = time.perf_counter()
        out = fln_detect(*a, **k)
        detect_ms.append((time.perf_counter() - t0) * 1e3)
        dets.append(out)
        return out

    def solve(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fln_solve(*a, **k)
        end.record()
        solve_ev.append((start, end))
        return out

    captures = [0]

    def capture(self, *a, **k):
        captures[0] += 1
        return graphed_capture(self, *a, **k)

    fln_detect, fln_solve, graphed_capture = fln.detect_tags, fln.estimate_camera_pose, \
        GraphedStep._capture
    fln.detect_tags, fln.estimate_camera_pose, GraphedStep._capture = detect, solve, capture
    syncs = []
    try:
        truths, t0 = [], 10 ** 9
        cuda.reset_launches()
        for i in range(FID_FRAMES):
            a = 2 * np.pi * i / FID_FRAMES
            cam_T_world = look_down([0.25 + 0.08 * np.sin(a), 0.05 * np.cos(a),
                                     0.9 + 0.3 * i / (FID_FRAMES - 1)],
                                    np.deg2rad(3.0) * np.cos(a))
            truths.append(np.linalg.inv(cam_T_world) @ node.cam_T_body)
            img = render_tags(node.tag_map, node.tag_size_m, cam_T_world, cam, FID_NOISE, seed=i)
            ts = t0 + i * FID_PERIOD_NS
            with SyncLog() as log:
                log.armed = True
                bus.publish("sensors/stereo", StereoImageMessage(
                    ts, 0, ImageMessage.from_array(ts, img), ImageMessage.from_array(ts, img)))
            syncs.append(sum(log.counts.values()))
        launches = dict(cuda.LAUNCHES)
        torch.cuda.synchronize()
        if len(fixes) != FID_FRAMES or node.num_fixes != FID_FRAMES:
            raise AssertionError(f"fiducial (a): {len(fixes)} fixes of {FID_FRAMES} frames")
        if any(launches.values()):
            raise AssertionError(f"fiducial (a) launched kernels of the port: {launches}")
        errs, cpu_errs = [], []
        for m, truth, det in zip(fixes, truths, dets):
            T = fix_matrix(m)
            errs.append(pose_errors(T, truth))
            known = [d for d in det if d.tag_id in node.tag_map]
            world_T_cam, res = estimate_camera_pose(
                known, node.tag_map, node.tag_size_m, *node.intrinsics,
                sigma_px=node.corner_sigma_px, device="cpu")
            cpu_errs.append(pose_errors(T, world_T_cam @ node.cam_T_body))
        solve_ms = [s.elapsed_time(e) for s, e in solve_ev]
        et, er = np.array(errs).T
        ct, cr = np.array(cpu_errs).T
        print(f"[fiducial] {FIDUCIAL_YAML} on {FARMSIM_YAML} ({cam.width}x{cam.height}), "
              f"{len(node.tag_map)} mapped tags of {node.tag_size_m} m, on {dev} | {smi}: "
              f"{len(fixes)} fixes of {FID_FRAMES} frames {FID_PERIOD_NS / 1e9:g} s apart at "
              f"0.9-1.2 m, tilted up to 3 deg; against the rendered truth max {et.max():.4f} m, {er.max():.4f} rad "
              f"(bounds {FID_MAX_T}, {FID_MAX_R}); against the CPU's solve on the same "
              f"detections max {ct.max():.2e} m, {cr.max():.2e} rad (bound {FID_CPU_TOL}); "
              f"detect (host) {percentiles(detect_ms)}; solve (card, CUDA events) first "
              f"{solve_ms[0]:.3f} ms, then {percentiles(solve_ms[1:])}; graph captures "
              f"{captures[0]}; host syncs a fix: first {syncs[0]}, then {sorted(set(syncs[1:]))}; "
              f"kernels of the port launched: none")
        if et.max() > FID_MAX_T or er.max() > FID_MAX_R:
            raise AssertionError(f"fiducial (a): a fix {et.max()} m, {er.max()} rad from the truth")
        if ct.max() > FID_CPU_TOL or cr.max() > FID_CPU_TOL:
            raise AssertionError(f"fiducial (a): a fix {ct.max()} m, {cr.max()} rad from the CPU's")
        if dev.type == "cuda" and captures[0] < 1:
            raise AssertionError("fiducial (a): the solve captured no CUDA graph on the card")

        # The 2-tag map's known weakness: one frame from FID_FAR m.
        cam_T_world = look_down([0.25, 0.0, FID_FAR], np.deg2rad(2.0))
        truth = np.linalg.inv(cam_T_world) @ node.cam_T_body
        before = len(fixes)
        ts = t0 + FID_FRAMES * FID_PERIOD_NS
        img = render_tags(node.tag_map, node.tag_size_m, cam_T_world, cam, FID_NOISE, seed=99)
        bus.publish("sensors/stereo", StereoImageMessage(
            ts, 0, ImageMessage.from_array(ts, img), ImageMessage.from_array(ts, img)))
        known = [d for d in dets[-1] if d.tag_id in node.tag_map]
        if len(fixes) > before:
            ft, fr = pose_errors(fix_matrix(fixes[-1]), truth)
            far = f"published, {ft:.4f} m and {fr:.4f} rad from the truth"
        else:
            out = estimate_camera_pose(known, node.tag_map, node.tag_size_m, *node.intrinsics,
                                       sigma_px=node.corner_sigma_px, device=dev) \
                if known else None
            far = "not published" + (
                f" (the solve: {pose_errors(out[0] @ node.cam_T_body, truth)[0]:.4f} m, "
                f"success {bool(out[1].success)}, mean error "
                f"{float(out[1].error) * node.corner_sigma_px:.3f} px)" if out else "")
        print(f"[fiducial] one frame from {FID_FAR} m ({len(known)} mapped tags detected): "
              f"{far} (recorded, not bounded: the 2-tag map's weakness, JAX's node alike)")
    finally:
        fln.detect_tags, fln.estimate_camera_pose, GraphedStep._capture = fln_detect, fln_solve, \
            graphed_capture

    # (b) the loop closed into the state estimator node on the card.
    parser = YamlParser(node_path=VIO_YAML, shared_path=FARMSIM_YAML)
    params = dataclasses.replace(load_state_estimator_params(parser),
                                 min_sec_btw_keyposes=1e6, max_sec_btw_keyposes=2e6)
    bus = InProcessBus()
    est = StateEstimatorNode(bus, load_rig(parser), params, device=dev)
    bus.publish("vio/init_pose", PoseStampedMessage(timestamp=0,
                                                    pose=np.array([1.0, 0, 0, 0, 0, 0, 0])))
    fid = fln.FiducialLocalizerNode(
        bus, *node.intrinsics, node.tag_map, node.tag_size_m,
        body_T_cam=np.linalg.inv(node.cam_T_body), channel_input="fiducial/stereo",
        pose_sigma_t=0.01, pose_sigma_r=0.01, device=dev)
    last_t = 0
    for i in range(1, 201):
        last_t = int(i * 1e7)
        bus.publish("sensors/imu", ImuMessage(last_t, np.zeros(3),
                                              -np.asarray(params.n_gravity) + FID_IMU_BIAS))
    drift = float(np.linalg.norm(est.est.filter_state().world_T_body[:3, 3]))
    cam_T_world = look_down([0.25, 0.02, 1.0], np.deg2rad(3.0))
    truth = np.linalg.inv(cam_T_world) @ node.cam_T_body
    img = render_tags(node.tag_map, node.tag_size_m, cam_T_world, cam, FID_NOISE, seed=7)
    msg = StereoImageMessage(last_t, 0, ImageMessage.from_array(last_t, img),
                             ImageMessage.from_array(last_t, img))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bus.publish("fiducial/stereo", msg)
    p = est.est.filter_state().world_T_body[:3, 3]
    snap_ms = (time.perf_counter() - t0) * 1e3
    snapped = float(np.linalg.norm(p - truth[:3, 3]))
    print(f"[fiducial loop] {VIO_YAML} (keyposes held off) on {dev} | {smi}: IMU at rest "
          f"biased by {FID_IMU_BIAS.tolist()} m/s^2 for 2 s drifted the filter {drift:.4f} m; "
          f"one sighting ({fid.num_fixes} fix) snapped it to {snapped:.4f} m from the truth "
          f"(bound {FID_MAX_SNAP}); publish to snapped filter state {snap_ms:.3f} ms "
          f"(host clock: detect, solve, the filter's update and replay, the read-back)")
    if not drift > 0.1 or fid.num_fixes != 1 or not snapped < FID_MAX_SNAP:
        raise AssertionError(f"fiducial loop: drift {drift} m, {fid.num_fixes} fixes, "
                             f"snapped {snapped} m")


LK_FAR_SHIFT = 40  # phase 20 (b): features move -40 px a frame, 5 px at level 3
# Phase 20 (b)'s backward check: the 2 finest levels from the round-trip
# target (LKParams.bwd_levels). The coarse start seeds only the forward
# walk; a backward walk over every level from zero motion cannot reach 5 px
# at level 3 either, and would fail every track (JAX's tracker alike).
LK_FAR_BWD_LEVELS = 2


def lk_option_params(**lk_fields) -> ObjectMesherDeviceParams:
    """The frontend's default parameters with these LKParams fields."""
    base = ObjectMesherDeviceParams()
    lkp = dataclasses.replace(base.tracker.lk, **lk_fields)
    return dataclasses.replace(base, tracker=dataclasses.replace(base.tracker, lk=lkp))


def phase_coarse_kernel(calls: list, tag: str) -> dict:
    """lk_coarse_match against its twin on one frame's recorded call
    (bit-identical), then its times, bound and chain."""
    calls = [c for c in calls if c[0] == "lk_coarse_match"]
    if len(calls) != 1:
        raise AssertionError(f"{tag}: expected one lk_coarse_match a frame, got {len(calls)}")
    name, args, kwargs, launch = calls[0]
    got = lk.coarse_block_match(*args, **kwargs).nan_to_num(-1e30)
    want = lk.coarse_block_match_plain(*args, **kwargs).nan_to_num(-1e30)
    require_equal(f"{tag} lk_coarse_match", got, want)
    times = measure("lk_coarse_match", lambda: cuda.lk_coarse_match(*launch),
                    lambda: lk.coarse_block_match_plain(*args, **kwargs), 5)
    b = coarse_bounds(calls[0])
    row = dict(max_abs_err=max_abs(got, want), **summarize([times]), **b)
    print(f"[{tag}] lk_coarse_match (points {tuple(args[2].shape[:-1])}, level "
          f"{tuple(args[1].shape[-2:])}, search {kwargs['search']}, patch {kwargs['patch']}): "
          f"bit-identical to its twin; {times_line(row)}; bound {b['bound_ms']:.5f} ms "
          f"({b['bound_by']}), chain of {b['chain_ops']} dependent operations "
          f"({b['chain_ms']:.5f} ms); no single PyTorch call computes the match")
    return row


def lk_option_fleet(canvas, rig, params, shift: int, phase: int, per_call: dict,
                    tag: str, dev) -> None:
    """multi_camera_frontend_step on N_CAMERAS cameras of uint8 mono 720p
    frames at the farm point (fleet_frames(canvas, 2, phase, dev, shift)): a
    keyframe call, then a tracked one, each launching per_call, as one
    camera's call does; each camera against its one-camera
    full_frontend_step (fleet_camera_alone, phase 13's rule)."""
    B = N_CAMERAS
    config = PerceptionConfig(engine="patchmatch", max_disp=MAX_DISP, internal_scale=FARM_SCALE)
    frames = fleet_frames(canvas, 2, phase, dev, shift)
    state, graph = create_fleet_frontend_state(B, params, image_shape=(H, W), device=dev)
    prev = to_grayscale(prepare_frames(frames[0][0], dev))
    prev0, outs = prev, []
    for i, (left, right) in enumerate(frames):
        cuda.reset_launches()
        out, prev = multi_camera_frontend_step(state, graph, prev, left, right, rig, config,
                                               params, device=dev)
        require_launches(f"{tag} B={B} call {i}", dict(cuda.LAUNCHES), per_call, 1)
        state, graph = out.tracker_state, out.graph
        outs.append(out)
    alive = outs[-1].tracker_state.table.alive.sum(-1).tolist()
    exact = [fleet_camera_alone(tag, b, frames, outs, prev0, rig, config, params, dev,
                                per_call)["exact"] for b in range(B)]
    px, disp, enh = (sum(e[j] for e in exact) for j in range(3))
    n = B * len(outs)
    print(f"[{tag}] B={B} uint8 mono at internal_scale={FARM_SCALE}, 2 calls: launches a call "
          f"{per_call} at B={B} and at B=1; alive after the tracked call {alive}; every camera's "
          f"disparity map, depth, labels, slot ids and alive set equal to its one-camera call "
          f"in {n} of {n} calls, pixels bit-identical in {px}, stripe "
          f"disparities in {disp}, enhanced image in {enh} (within the enhance tolerance in all)")
    if min(alive) < 50:
        raise AssertionError(f"{tag}: {alive} landmarks alive")


def phase_lk_options(rig, config, dev, rows: dict) -> tuple[dict, dict]:
    """Phase 20: the LK tracker's two options on the frontend at 720p (see
    the module docstring). Returns lk_track's row in the unbounded mode and
    lk_coarse_match's, each with its launches on its path."""
    t0 = time.perf_counter()
    slack_row = rows["lk_track"]

    # (a) the unbounded walk on phase 10's sequence.
    p_a = lk_option_params(search_slack=0)
    fe_a = phase_frontend(make_canvas(), rig, config, dev, p_a, tag="lk unbounded")
    row_a = phase_lk_kernels(fe_a["calls"], "lk unbounded")["lk_track"]
    print(f"[lk unbounded] lk_track in the unbounded mode: device "
          f"{row_a['device_ms'] * 1e3:.3f} us a launch ({row_a['device_method']}) against {slack_row['device_ms'] * 1e3:.3f} us in "
          f"the slack mode (phase 9); bound {row_a['bound_ms'] * 1e3:.3f} us "
          f"({row_a['bound_by']}) against {slack_row['bound_ms'] * 1e3:.3f}; chain "
          f"{row_a['chain_ms'] * 1e3:.3f} us against {slack_row['chain_ms'] * 1e3:.3f}")
    phase_frontend_graph(fe_a, rig, config, 2 * row_a["device_ms"], "lk unbounded graph",
                         "2 lk_track launches in the unbounded mode")

    # (b) the coarse start on a sequence moving LK_FAR_SHIFT px a frame.
    wide = make_canvas(100 + LK_FAR_SHIFT * (5 + N_FRAMES) + TRUE_DISP)
    p_b = lk_option_params(coarse_init=True, bwd_levels=LK_FAR_BWD_LEVELS)
    per_b = dict(PER_FRONTEND_FRAME, lk_coarse_match=1)
    fe_b = phase_frontend(wide, rig, config, dev, p_b, LK_FAR_SHIFT, per_b, "lk coarse")
    track_b = phase_lk_kernels(fe_b["calls"], "lk coarse")["lk_track"]
    row_b = phase_coarse_kernel(fe_b["calls"], "lk coarse")
    phase_frontend_graph(fe_b, rig, config, 2 * track_b["device_ms"] + row_b["device_ms"],
                         "lk coarse graph", "2 lk_track launches and 1 lk_coarse_match")
    # The default parameters on the same sequence: recorded, not bounded.
    base = ObjectMesherDeviceParams()
    state = StereoTrackerState.create(base.tracker, image_shape=(H, W), device=dev)
    graph = LandmarkGraph.create(base.tracker.capacity, device=dev)
    prev = to_grayscale(fe_b["frames"][0][0])
    errs = []
    for left, right in fe_b["frames"][:5 + N_FRAMES]:
        out, prev = full_frontend_step(state, graph, prev, left, right, rig, config, base,
                                       device=dev)
        errs.append(track_error(state.table, out.tracker_state.table, LK_FAR_SHIFT))
        state, graph = out.tracker_state, out.graph
    errs = torch.cat(errs)
    print(f"[lk coarse] the default parameters (no coarse start, full backward check) on the "
          f"same sequence: {errs.numel() // 2} tracks over {5 + N_FRAMES} frames, median |track "
          f"error| {float(errs.median()) if errs.numel() else float('nan'):.5f} px, "
          f"{int(state.table.alive.sum())} alive (recorded, not bounded); with the coarse start: "
          f"median {fe_b['med_err']:.5f} px, {fe_b['alive']} alive")

    # (c) the fleet, each option.
    lk_option_fleet(make_canvas(), rig, p_a, SHIFT, FLEET_PHASE, PER_FRONTEND_FRAME,
                    "lk unbounded fleet", dev)
    lk_option_fleet(wide, rig, p_b, LK_FAR_SHIFT, 1, per_b, "lk coarse fleet", dev)
    print(f"[lk options] phase 20 in {time.perf_counter() - t0:.1f} s")
    return (dict(row_a, launches=fe_a["launches"]["lk_track"], frames=N_FRAMES),
            dict(row_b, launches=fe_b["launches"]["lk_coarse_match"], frames=N_FRAMES))


def main() -> int:
    name, smi = phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    canvas = make_canvas()
    left_np, right_np = make_inputs(canvas)
    left_rgb = torch.as_tensor(left_np, device=dev)
    right_rgb = torch.as_tensor(right_np, device=dev)
    cam = PinholeCamera.create(700.0, 700.0, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, baseline=0.12)
    config = PerceptionConfig(engine="patchmatch", max_disp=MAX_DISP, internal_scale=SCALE)

    l2 = l2_latency(dev)
    rows = phase_kernels(left_rgb, right_rgb, l2)
    fits = record_fit_calls(lambda: perception_step(left_rgb, right_rgb, rig, config, device=dev))
    rows.update(phase_fit_kernel(fits))
    # The step no longer launches lm_solve_small and lm_row_sum: hold them to
    # their twins on the fits' loop with the kernels, on the same fits.
    rows.update(phase_lm_kernels(record_fit_loops(fits, "perception_step")))
    launches, disp, runs = phase_end_to_end(left_rgb, right_rgb, rig, config)
    phase_graph(left_rgb, right_rgb, rig, config, disp, runs,
                ("pm_match", rows["pm_match"]["graph_ms"]))
    phase_stage_times(left_rgb, right_rgb, rig, config)
    phase_cpu_parity(left_rgb, right_rgb, rig, config, disp)

    rows.update(phase_strip_kernels(left_rgb, right_rgb, l2))
    strip_config = dataclasses.replace(config, use_strip_volumes=True)
    strip_launches, strip_disp, strip_runs = phase_end_to_end(left_rgb, right_rgb, rig,
                                                              strip_config, "strip e2e",
                                                              PER_STRIP_FRAME)
    require_equal("strip-volume perception disparity vs the (H, W, D) path's", strip_disp, disp)
    phase_graph(left_rgb, right_rgb, rig, strip_config, disp, strip_runs,
                ("pm_match_strip", rows["pm_match_strip"]["graph_ms"]), "strip graph")
    phase_engines(left_rgb, right_rgb, rig, canvas)

    fe = phase_frontend(canvas, rig, config, dev)
    rows.update(phase_lk_kernels(fe["calls"]))
    phase_frontend_graph(fe, rig, config, 2 * rows["lk_track"]["device_ms"])
    phase_frontend_stage_times(fe, rig, config)
    phase_frontend_cpu_parity(fe, rig, config)
    batched = phase_batched(canvas, rig, config, rows, l2)
    fleet_lk, fleet_fit, fleet_lm = phase_fleet(canvas, rig, rows, dev)
    phase_farm_node(canvas, dev)
    phase_mesher_node(canvas, dev)
    vio, mission = phase_state_estimator(dev, smi)
    deploy = phase_vio_deploy(dev, mission)
    sharded = phase_sharded(canvas, rig, config, dev)
    phase_fiducial(dev, smi)
    unbounded, rows["lk_coarse_match"] = phase_lk_options(rig, config, dev, rows)

    # Launches on each kernel's own path: cost_volume's and pm_match's from
    # perception_step, build_volumes' and pm_match_strip's from
    # perception_step with strip volumes, LK's from full_frontend_step.
    launches.update({k: strip_launches[k] for k in PER_STRIP_FRAME})
    launches["lk_track"] = fe["launches"]["lk_track"]
    # lk_coarse_match's, from full_frontend_step with the coarse start
    # (phase 20 (b)); lk_track's unbounded mode's beside its row (phase 20 (a)).
    launches["lk_coarse_match"] = rows["lk_coarse_match"].pop("launches")
    rows["lk_track"]["unbounded"] = unbounded
    # The batched path's numbers beside each stereo kernel's row (phase 12).
    for k, row in batched.items():
        rows[k]["batched"] = dict(cameras=N_CAMERAS, **row)
    # And lk_track's, from the fleet frontend (phase 13).
    rows["lk_track"]["batched"] = dict(cameras=N_CAMERAS, **fleet_lk)
    # And its calls on the state estimator's path (phase 16), with their launches there.
    rows["lk_track"]["vio"] = vio
    # And its launches on the state estimator node's, the player's and the
    # threaded estimator's paths (phase 17 (a), (c), (d)).
    rows["lk_track"]["vio_node"] = deploy["lk_track"]["node"]
    rows["lk_track"]["vio_player"] = deploy["lk_track"]["player"]
    rows["lk_track"]["vio_threaded"] = deploy["lk_track"]["threaded"]
    # And sea_thru_fit's, from the fleet frontend's enhancement (phase 13).
    rows["sea_thru_fit"]["fleet"] = dict(cameras=N_CAMERAS, **fleet_fit)
    # The LM kernels' launches are trilaterate's in float64 (phase 17 (e)),
    # their path since the step's fits are one launch; their rows carry
    # the fits' loop with the kernels at the step's and the fleet's shapes.
    for k, row in fleet_lm.items():
        rows[k]["batched"] = dict(cameras=N_CAMERAS, path="the fits' loop", **row)
        rows[k]["trilaterate"] = deploy["trilaterate"][k]
        launches[k] = deploy["trilaterate"][k]["float64"]["launches"]
    # pm_pass's, from the sharded step at the largest block count (phase 18).
    launches["pm_pass"] = sharded.pop("launches")
    rows["pm_pass"] = sharded
    kernels = [
        dict(name=k, route="cuda", source=SOURCES[k][0], replaces=SOURCES[k][1],
             launches=launches[k], **{"library_ms": None, **rows[k]})
        for k in SOURCES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
