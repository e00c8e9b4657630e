#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``toyslam_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and holds each against its plain PyTorch
version on the card. Then it drives its paths through the entry points a
user calls, each with the launch counts set to 0 just before it and read
just after:

- NDT: one exact-mode ``ndt_align`` (the align.cpp configuration) and
  ``ndt_odometry`` under the shipped ``OdometryConfig`` over 16 generated
  262144-ray scans (kernels K1-K3);
- registration: ``gicp_align`` and ``icp_align`` on the generated 32 x
  2048-ray pair, downsampled at 0.1 m and padded to 32768 points (K4-K6);
- the bf16-split ranking diagnostic ``diag.diag_bf16_concat`` at 16384 x
  16384, all five modes (D1);
- the row-gather diagnostic ``diag.profile_gather_modes`` at the fleet's
  shape, 64 lanes x 8192 rows x 16 columns, 57344 ids a lane (D2);
- mapping: ``ndt_mapping`` over the odometry scans into a 65536-voxel map
  (K2, K3), then ``mapping_init``/``mapping_step`` with a checkpoint after
  scan 7, coarse-to-fine ``ndt_odometry`` over 8 scans, the drifting
  64-scan sequence of the JAX package's golden-chain test through
  ``ndt_mapping``, and the app ``python -m
  toyslam_tpu_torch.apps.mapping_demo`` (batch, ``--stream``,
  ``--resume``) on 6 of the scans written as PCDs;
- the align app ``python -m toyslam_tpu_torch.apps.align --json`` on the
  align-65k pair written as PCDs (ICP, GICP, NDT DIRECT7/1/27: K1, K4-K6),
  then the NDT search helpers on its clouds (``fitness_score`` through
  K4, ``lookup_neighbors``, ``nearest_k_search``, ``radius_search``);
- ICP-SLAM: the app ``toyslam_tpu_torch.apps.icp_demo`` at its defaults
  and ``pipelines/icp_slam.icp_slam`` on its scenario (K4);
- ``pipelines/fusion.ndt_eskf_fusion`` over the 16 odometry scans with a
  seeded IMU log of 20 ticks a scan (K2, K3, then the ESKF), and the app
  ``toyslam_tpu_torch.apps.uwb_demo`` at its defaults over 30 s;
- the fleet (BASELINE config 5): ``pipelines/fusion.fleet_fusion`` over
  64 lanes of 16 scans of 16 x 1024 rays (K2, K3 with a lane axis, the
  ESKF over lanes), its chunks swept, and ``parallel/batch.vmap_align``
  on the lanes' first pairs (K1 with a lane axis);
- LOAM and the sliding-window smoother, which run no kernel of their own
  (phases 25-26);
- GNSS, no kernel of its own either (phase 27): ``bench.py``'s 1024-epoch
  log through ``gnss/local.prep_epochs`` (f64) and
  ``solve_epochs_local`` (f32) on the card, ``gnss/pipeline.run_epochs``
  in f64 on the card, and the apps ``gnss_demo``, ``raim_demo`` and
  ``urban_demo`` at their defaults;
- ROS bags and the host runtime (phase 28; K2, K3): the odometry scans
  written as an lz4 bag (bag-256k) by ``runtime/rosbag.write_bag``, read
  by the C bag reader of the host library (``csrc/host``, built by gcc in
  phase 1) into ``ndt_mapping``, ``runtime/loader.ScanStream`` over the
  same scans as PCDs into ``mapping_step``, and the apps
  ``mapping_demo`` on a bag, ``fusion_demo`` and ``gnss_demo`` with
  ``--write-bag`` and then ``--bag``;
- the rest of ``parallel/batch`` (phase 29; K1-K3 on point shards):
  ``sharded_batch_fusion`` over smoother-fleet-64 (64 of the benchmark's
  smoother logs of 32 keyframes) in f64 and f32 at chunk 64, and in f32
  at chunk 16 over the first 32 logs (two chunks in turn),
  ``sharded_align`` of the align-65k pair over ``[cuda:0] x 1, 2, 4`` in
  exact and frozen mode, and the same align split between two processes
  joined by ``initialize_multihost`` over Gloo.

Phase 2 also checks the single-cloud API (``api_check``):
``core/pointcloud.voxel_ids`` and ``unique_voxel_slots`` on the first
odometry scan at the 0.3 m leaf, int for int against the same calls on
the CPU and with as many voxels as that scan's downsample, ``ops/eigh3.
eigh3`` on the covariances of that scan's map against a host f64 run,
and ``runtime/native.available()``; and ``eigh3_soa`` through its kernel
against ``eigh3_soa_plain`` on the card bit for bit, one launch a call, at
the main paths' shapes in f32 and f64 (``eigh3_phase``). The eigensolver's
launches are counted on the main paths: one a map build (NDT path,
mapping), two a ``gicp_align``, 20 a ``loam_step`` (phase 25).

It checks that every align converged and improved on its identity guess
against the generated ground truth, that the card's exact NDT align lands
on the port's f64 align of the same pair on the CPU, that the kernels
were launched, that the results match the same runs through the plain
versions (K2, K4 and D2 bit for bit; K1's in-kernel neighbour hash bit for
bit against the plain hash; K1 and K3 at every evaluation of the plain
odometry) and are bit-identical on a rerun, that one NDT evaluation is
three device operations, one K6 call one and a GN step two (K6 and
``gicp_update``), counts the host syncs and
K4's rescored columns, and prints the timings with the card's name and
power limit. For mapping it checks that the map never fills, that its
poses equal the odometry's bit for bit, that chained steps and a resume
equal the batch run bit for bit, that the merge adds no host sync, that
the card's map matches the same merges on the CPU (at most 0.1 % of
voxels differ, means within 1e-4 m), that coarse-to-fine runs the same
through kernels and plain versions and sums both stages' evaluations,
that the trajectory lies within the golden chain's bounds (ATE rmse
1e-3 m aligned, 5e-3 m unaligned max; ``tests/golden_ndt.py`` in f64 on
the same downsampled clouds), and that the app's batch, stream and resume
files are equal. For the later paths it checks that the align app's five
methods converge and improve on the identity, that each fitness it prints
equals ``fitness_score`` on the same clouds and pose and that each method
launched its kernels, and that on the app's own clouds (at most 24576
voxels) each method's kernels agree with their plain versions at every
call of its plain route (K4 bit for bit, K5 within 1 bf16 ulp, K1 and K6
within 2e-6 of their terms' magnitudes, ``gicp_update`` within
``UPDATE_STEP_RTOL`` of its step plus ``UPDATE_ULPS`` f32 ulps), with
the two routes' poses
within the kernel-vs-plain bounds of the NDT and registration phases;
that ``fitness_score`` through K4 equals its plain
route bit for bit and the f64 CPU result within 2e-6; that the search
helpers agree with the CPU's; that ``icp_demo`` and ``uwb_demo`` pass
their gates (``uwb_demo``'s fused ATE also below its trilateration's);
that ``icp_slam`` through K4 equals its plain route bit for bit; and that
the fusion's poses equal phase 4's odometry bit for bit, its fused track
lies within 5e-6 m of the same log through the f64 ESKF on the CPU and
``eskf_run`` makes no host sync. For the fleet it checks that every lane
converged with a finite trajectory, that the lanes' iterations differ,
that each lane checked (one of every other scene in the first chunk,
its start scans in turn, and one of every other chunk) equals
``ndt_odometry`` alone bit for bit and its fused track its
own ESKF run within 3e-6 m, that every K1/K3 lane row equals the
single-lane launch on its lane bit for bit and its plain version within
``TERMS_MAG_RTOL``, and every K2 launch its plain version bit for bit,
along one chunk of ``fusion.FLEET_CHUNK`` lanes through the plain
versions, that a lockstep align makes one host sync a round, that ``eskf_run``
over lanes makes none, that chunks change no lane and a rerun is
bit-identical. For LOAM (phase 25: ``pipelines/loam.loam_odometry`` over
64 scans of HDL-32E's 32 x 1800 rays and over the benchmark's 64 of 16 x
360, then ``apps/loam_demo`` at its defaults) it checks finite poses, a
keyframe, no host sync and a bit-identical rerun of the first
``LOAM_RERUN_SCANS`` scans, and holds each run to
the port's f64 run of the same scans on the host: over the scans that
f64 run tracks within 0.3 m (the drive loses track after ~25 scans in
both packages) the ATE below 0.3 m, before the two runs' keyframe
choices split the positions within ``LOAM_F64_TOL_M``, and a split only
within a few scans of the f64 run losing track; each feature pick of the
benchmark's scans that
differs from the f64 run's must lie within the f32 error of a tie, a gate
or a sector or ring border. For the smoother (phase 26: ``pipelines/
batch_fusion`` over the benchmark's 256-keyframe log, window 20, then
``apps/fusion_demo`` over 10 s) it checks finite outputs, a resume
from a checkpoint at keyframe 224 bit-identical to the run, host syncs
only from ``eigh`` (one a marginalisation), the f32 drift from the host's
f64 run within twice the JAX package's own on that log, the JAX window
test's inputs within that test's f32-vs-f64 bounds, and the app's gate.
For GNSS (phase 27) it checks that every epoch of the f32 solve is
valid, that the solve makes no host sync and reruns bit-identically, that
it lies within the JAX package's f32-vs-f64 bounds (0.1 m, 0.1 m, 0.05
m/s, DOP rtol 2e-2, equal satellite counts) of the host's f64 local
solve on every epoch and of its f64 ``run_epochs`` on the epochs whose
masks agree (at most ``GNSS_MASK_SPLIT_MAX`` do not), that
``run_epochs`` in f64 on the card lands within ``GNSS_F64_POS_M`` of the
host's, and that the three apps pass their gates (``gnss_demo``'s ATE
below 5 m). For the bag (phase 28) it checks that the bag through the C
and the Python reader and the same scans as PCDs through the C packer and
through Python give byte-equal stacks, times and counts (and a bz2 bag
the same through both readers), that the bag's ``ndt_mapping`` launched
K2 and K3, converged and lies within the ground-truth bounds of phase 4,
that ScanStream's poses and map equal the preloaded stack's and the
bag's ``ndt_mapping``'s bit for bit, that 200 threaded ``pack_scans``
calls all succeed and equal the Python packer, that ``StageTimer`` waits
for the card and agrees with the host clock, that ``mapping_demo`` on a
bag writes phase 18's pose columns and map bytes, that ``fusion_demo``'s
bag replay passes ``tests/test_apps.py``'s gate (smoothed vs raw fixes <
0.5 m) and that ``gnss_demo``'s replay solves to its simulation's ENU
positions. For ``parallel/batch`` (phase 29) it checks that the 64
smoother lanes are finite, make one host sync a marginalisation round (a
chunk's ``eigh``) and nothing else, that lanes 0-3 in f64 lie within
``FLEET_LANE_F64_M`` of their single-log runs on the card and the f32
lanes within twice the JAX package's f32 drift of the f64 lanes; that
each sharded align converged with the unsharded align's iterations and
a transform within 1e-5 of it, launched K1 (exact) or K2 and K3 (frozen)
once a shard an evaluation or gather with one host copy a shard an
evaluation, and that each shard's kernel call agrees with its plain
version along the plain route; and that the two processes' align equals
the one-process align over two entries. The f64 host runs of phases
25-27 and phase 28's files (written by a host job) go in processes of
their own, started at the beginning. The card's line comes before the
``{"kernels": [...]}`` line, and the last line is ``{"ok": true,
"device": {...}}``; the line before the card's gives the whole script's
seconds.
Any failure exits non-zero before it. There is no CPU path: without a CUDA
device the script exits with 1.
"""

from __future__ import annotations

import csv
import json
import re
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np

ODO_SCANS = 16  # 64 x 4096 = 262144 rays each
ALIGN_RAYS = (32, 2048)  # the ~65k-point HDL-32-class single-align pair
ALIGN_FOV = (-30.67, 10.67)
REG_CAPACITY = 32768  # the 0.1 m pair's 27201/27316 points, nothing cut
REPS = 20  # timed launches per kernel, after warm-up
TERMS_RTOL = 1e-4  # K1/K3/K6 sums vs plain, relative to the group's largest
# K1/K3/K6 sums vs plain along a path, relative to the summed magnitudes
# of each sum's terms: two f32 sums of N terms in other orders differ by up
# to ~2 log2(N) 2^-24, 1.8e-6 at N 24576 (the card read 8.66e-7 on K6 at
# GICP's optimum, 1.83e-7 on K1; NVIDIA H100 80GB HBM3, 700 W); one
# pair's terms dropped from 24576 would read ~4e-5.
TERMS_MAG_RTOL = 2e-6
# gicp_update against its plain version: the outputs within UPDATE_STEP_RTOL
# of the plain step (the largest change of a param) plus UPDATE_ULPS f32
# ulps of the largest param. Two f32 LUs of GICP's normal matrices
# (condition ~1e3) part by ~1e3 2^-24 of the step; the poses' last ulps
# round apart in so3_exp(dtheta) R.
UPDATE_STEP_RTOL = 1e-3
UPDATE_ULPS = 4
# The update's operations: the 6x6 LU with partial pivoting and the two
# substitutions (~160), so3_exp (~50 with sinf, cosf) and R' = E R (45).
GICP_UPDATE_FLOPS = 255
PAIRS_TOL_M, PAIRS_TOL_RAD = 1e-3, 1e-4  # kernel vs plain odometry poses
# eigh3 in f32 on the card against f64 on the host, on the same f32
# covariances: eigenvalues and the reconstruction V diag(w) V^T relative
# to each matrix's largest eigenvalue (a few f32 ulps through 5 sweeps),
# and the angle of each eigenvector whose eigenvalue lies at least
# EIGH3_GAP of the largest from the others (f32 rounding over the gap).
EIGH3_RTOL, EIGH3_GAP, EIGH3_ANGLE = 1e-5, 0.1, 1e-4
# The card's f32 exact align vs the port's f64 align on the CPU (JAX and
# the port agree to 3.5e-5 m in f32 on this pair).
ALIGN64_TOL_M, ALIGN64_TOL_RAD = 1e-3, 1e-3
NN_SHARE = 0.999  # K5 entries within 1 bf16 ulp
GICP_TOL_M, GICP_TOL_RAD = 1e-4, 1e-4  # kernel vs plain GICP pose
ICP_TOL_M, ICP_TOL_RAD = 1e-3, 1e-3  # kernel vs plain ICP pose
# Mapping (phases 12-18): the app's default map capacity, the map's bounds
# on the card against the same merges on the CPU, the JAX package's
# coarse leaf and golden-chain bounds (tests/test_ndt.py).
MAP_CAPACITY = 65536
CKPT_SCAN = 7
MAP_DIFFER_MAX = 1e-3  # share of voxels on one side only
MAP_MEAN_TOL_M = 1e-4  # matched voxels' means
COARSE_LEAF, COARSE_SCANS = 0.9, 8
GOLDEN_SCANS = 64
GOLDEN_RMSE_M, GOLDEN_MAX_M = 1e-3, 5e-3
APP_SCANS = 6
# Sanity bounds against ground truth (the data, not the port, limits the
# accuracy: an align can settle in a local minimum on the ring-sampled
# ground). Zero-motion estimates would give a 4.5 m ATE.
PAIR_MEDIAN_MAX_M = 0.02  # median per-scan relative translation error
ATE_MAX_M = 1.0
# Phases 19-23: the align app, the search helpers, ICP-SLAM, NDT + ESKF
# fusion and the UWB app.
APP_TIMEOUT_S = 600
# Bounds at about twice what the card showed (NVIDIA H100 80GB HBM3):
# fitness_score on the card (f32, K4) against the port's f64 on the CPU,
# relative (observed 1.01e-6); the centroid searches' f32 squared
# distances |q|^2 + |c|^2 - 2 q.c on the card (cuBLAS) against the CPU's
# f32, relative to |q|^2 + |c|^2, where the cancellation leaves a few f32
# ulps (observed 1.6e-7); the fused track on the card (f32) against the
# same log through the f64 ESKF on the CPU, in m (observed 1.98e-6).
FIT64_RTOL = 2e-6
SEARCH_D2_RTOL = 2.0 ** -21
FUSED_TOL_M = 5e-6
SEARCH_QUERIES = 4096
IMU_PER_SCAN = 20
SCAN_PERIOD_S = 0.1  # the generator's 0.3 m and 0.004 rad a scan at 10 Hz
# Phase 24, the fleet (BASELINE config 5): 64 lanes of 16 scans of 16 x
# 1024 rays at work_capacity 8192, 16 scenes of 19 scans each serving 4
# lanes from start scans 0-3; the chunks swept; the lanes of one chunk
# (``fusion.FLEET_CHUNK``) held to the plain versions at every evaluation
# and every regather; the lane launches timed
# at L 16 and 64. The fused track of a lane against its single-lane ESKF
# run, in m: the batched matrix products round otherwise (the card read
# 1.43e-6 m; NVIDIA H100 80GB HBM3, 700 W).
FLEET_LANES, FLEET_SCANS, FLEET_SEEDS = 64, 16, 16
FLEET_RAYS = (16, 1024)
FLEET_CAPACITY = 8192
FLEET_CHUNKS = (16, 64)
FLEET_LANE_WIDTHS = (16, 64)
FLEET_FUSED_TOL_M = 3e-6
# A scan's align that the fleet's kernel and plain routes end more than
# transformation_epsilon apart must sit on an edge of the data: the f64
# align through the plain versions, from the kernel route's warm start moved
# by a tenth of that epsilon (or from the routes' own warm starts, where
# an earlier align of the lane ended apart), ends more than it apart, and
# each route's end lies within it of one of those f64 ends
# (``align_edge``).
EDGE_MOVE = 1e-4
# Phase 25, LOAM: loam-hdl32, 64 scans of the test world (sim/loam_world)
# through HDL-32E's 32 rings at 0.2 deg (1800 rays a ring) over its -25..5
# deg, padded to the app's 65536 points, at LoamConfig()'s defaults; and
# loam-bench, bench.py:317-356's 64 scans of 16 x 360 rays (seed 3).
LOAM_SCANS = 64
LOAM_EIGH3_A_SCAN = 20  # _neighbourhood: 2 fits x 10 GN iterations a step
# The bit-identical rerun (and its host-sync count) covers the first scans
# only: a cut in depth that pays for phase 29 (a full rerun took 15-17 s a
# cell; the first scans' outputs do not depend on the later scans).
LOAM_RERUN_SCANS = 16
LOAM_HDL = (32, 1800)
LOAM_BENCH = (16, 360)
LOAM_CAPACITY = 65536
LOAM_FOV = (-25.0, 5.0)
LOAM_HDL_SEED, LOAM_BENCH_SEED = 0, 3
LOAM_CELLS = (("loam-hdl32", LOAM_HDL, LOAM_HDL_SEED, LOAM_CAPACITY),
              ("loam-bench", LOAM_BENCH, LOAM_BENCH_SEED, None))
LOAM_ATE_M = 0.3  # tests/test_loam.py's drift bound
# The drive loses track after ~25 scans in both packages (the JAX app over
# 64 frames reads an ATE of 67.6 m): the ATE is held over the scans the
# host's f64 run tracks within LOAM_ATE_M, the card's positions against
# that run's over the scans before their keyframe choices split (at least
# LOAM_MIN_TRACKED), and a split must come within LOAM_SPLIT_SCANS of the
# f64 run losing track (the onset of the failure, an edge of the data).
LOAM_MIN_TRACKED = 20
LOAM_SPLIT_SCANS = 4
# The card (f32) against the port's f64 run on the host before the
# keyframe choices split, in m: about twice the most that NVIDIA H100 80GB
# HBM3 at 700 W showed (0.021 m, loam-bench scan 24; 0.0065 m loam-hdl32).
LOAM_F64_TOL_M = 0.04
LOAM_PROFILE_SCANS = 4
# Phase 26, the smoother: smoother-w20, bench.py:284-314's log (256
# keyframes of 20 IMU samples, seed 2) through BatchFusionConfig() (window
# 20) in f32; a resume from a checkpoint at keyframe 224 (it re-runs the
# keyframes after it, 128 of them at 128; this cut in depth
# pays for phase 29 with fusion_demo's and LOAM's), and fusion_demo over
# FUSION_DEMO_S of its log (its default 25 s took 33 s on the H100).
SMOOTHER_RESUME_AT = 224
FUSION_DEMO_S = 10
SMOOTHER_PROFILE_KF = 4
# The JAX package's own f32-against-f64 drift of batch_fusion on that log
# (tests/jax_smoother_refs.py --drift on the CPU): its test bounds
# (tests/test_window.py:137-175) do not hold there, so the card's drift is
# held to twice JAX's. Those bounds are held on the inputs they were set
# on, the test's own (tests/fixtures/window_f32_k10_seed5.npz).
JAX_DRIFT_POS_M, JAX_DRIFT_VEL = 0.497061104964118, 2.160991981365262
WINDOW_F32_POS_M, WINDOW_F32_VEL_MEDIAN, WINDOW_F32_VEL_LATE = 1e-2, 5e-2, 0.15
HOST_REF_THREADS = 3
# Phase 27, GNSS: gnss-1024, bench.py:461-527's log (1024 epochs x 24
# satellites, numpy seed 4), f64 prep and the f32 local-frame solve on the
# card, held to the port's f64 run_epochs on the host within the JAX
# package's own f32-vs-f64 bounds (tests/test_gnss_local.py:32-62).
GNSS_EPOCHS, GNSS_SATS, GNSS_SEED = 1024, 24, 4
GNSS_POS_M, GNSS_CB_M, GNSS_VEL = 0.1, 0.1, 0.05
GNSS_DOP_RTOL = 2e-2
GNSS_ATE_M = 5.0  # the app's ENU ATE (test_local_f32_matches_f64_pipeline)
# prep_epochs masks elevations at the anchor, run_epochs at each epoch's
# warm start (as in the JAX package): 1.1 km from the anchor, a satellite
# near the 10 deg cut-off enters one and not the other at epochs 740-741
# of gnss-1024 (1.618 m apart in JAX's own f32-vs-f64 run too). The card
# is held to the host's f64 local solve (the same masks) on every epoch,
# and to run_epochs on the epochs whose masks agree; at most this many
# may disagree (twice the 2 seen).
GNSS_MASK_SPLIT_MAX = 4
GNSS_PROFILE_EPOCHS = 16
# run_epochs in f64 on the card over the log's first epochs (27.6 s for
# all 1024 on the card) against the same on the host (its first epochs of
# the whole run: each epoch depends on the earlier ones only), in m and
# m/s: the two differ only by the rounding of their sin/cos/atan2 and the
# order of their sums (NVIDIA H100 80GB HBM3, 700 W, over 1024 epochs:
# 2.14e-8 m, 4.51e-12 m/s).
GNSS_F64_EPOCHS = 256
GNSS_F64_POS_M, GNSS_F64_VEL = 1e-7, 2.5e-11
# Phase 28, the bag and the host runtime: bag-256k, the odometry scans'
# valid points as PointCloud2 (x, y, z, intensity f32) on /velodyne_points
# at 10 Hz stamps from BAG_T0, lz4 chunks, written by the port's
# rosbag.write_bag in a host job during phases 1-27; its four ingest routes
# (the bag through the C and the Python reader, the same scans as PCDs
# through the C packer and through Python) held byte-equal; ndt_mapping
# over it at the scans' 262144 capacity; ScanStream over the PCDs into
# mapping_step against the preloaded stack; the C packer's threads; the
# three bag apps; StageTimer around a spin and a mapping step.
BAG_TOPIC = "/velodyne_points"
BAG_T0 = 1738856408.0  # 2025-02-06 16:30:08, the reference's bag
BAG_CAPACITY = 64 * 4096  # mapping_demo --capacity, the scans' rays
INGEST_REPS = 3  # best of, host clock
RACE_CALLS, RACE_THREADS, RACE_SMALL = 200, 8, 24
FUSION_BAG_S = 5  # fusion_demo --duration for the bag round trip
FUSION_BAG_GATE_M = 0.5  # tests/test_apps.py:138-153's gate
STAGE_SPIN_MS = 50.0
# Phase 29, the rest of parallel/batch. smoother-fleet-64: 64 logs of
# bench.py:284-314's generator (numpy seeds 2-65; seed 2 is bench's own
# generator) of 32 keyframes of 20 IMU samples, BatchFusionConfig()
# (window 20: 12 marginalisations), through sharded_batch_fusion on the
# card in f64 (chunk 64) and f32 (chunk 64, and chunk 16 over the first
# FLEET_CHUNK16_LOGS); lanes 0-3 in f64
# against the single-log batch_fusion on the card, the f32 lanes against
# the f64 lanes within twice the JAX package's own f32 drift (phase 26's
# JAX_DRIFT_*). sharded-align: the align-65k pair (phase 3) over meshes
# [cuda:0] x 1, 2, 4 in exact mode (K1) and frozen with 4 regathers (K2,
# K3) against ndt_align, within the JAX test's 1e-5 with equal
# iterations (tests/test_fusion.py:91-95); multihost: two processes on
# cuda:0 joined by initialize_multihost (Gloo) split the pair.
FLEET_LOGS, FLEET_KF = 64, 32
FLEET_SEED0 = 2
# The f32 chunk-16 run covers the first 32 logs, two chunks in turn joined
# by fusion.cat_lanes, against the same lanes of the chunk-64 run: a cut in
# depth for time (all 64 logs, four chunks, took 45.7-51.6 s of a script
# that ran 1067.5 s on a slower host, NVIDIA H100 80GB HBM3, 700 W; each
# chunk takes about as long at 16 lanes as at 64).
FLEET_CHUNK16_LOGS = 32
FLEET_CHECKED_LANES = 4
FLEET_PROFILE_KF = 1
# Lanes 0-3 in f64 against the single-log runs on the card, in m: about
# twice what the card showed (4.14e-6 m, NVIDIA H100 80GB HBM3, 700 W;
# batched and single solves round otherwise, and the window's normal
# equations are ill-conditioned).
FLEET_LANE_F64_M = 1e-5
SHARD_MESHES = (1, 2, 4)
SHARD_TOL = 1e-5
SHARD_TIMING_REPS = 3
GLOO_TIMEOUT_S = 120
NEW_PATH_KERNELS = ("ndt_terms_gathered", "ndt_gather_repack",
                    "ndt_terms_packed", "nearest_neighbor", "neg_dist_bf16",
                    "gicp_terms", "gicp_update", "eigh3")
# The card's published peaks (H100 SXM at 700 W) for the bounds.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
# Operations counted from the kernel sources. The NDT terms
# (csrc/ndt_kernels.cu): per point (point_part) the transform 18 and the 8
# x.j and 15 x.h products 40 + 75, so 133; per pair (add_pair_terms) ~255
# plus the 28 accumulating adds, so 283; an offset-major count does both on
# every pair (416). Per pair also the GICP terms (csrc/gicp_kernels.cu
# pair_terms, ~117) plus 27 adds; the ranked distance (3 mul, 2 add, 1 mul,
# 1 sub, 1 compare or subtract).
NDT_FLOPS_PER_POINT = 133
NDT_FLOPS_TRANSFORM = 18  # the part of it that K1's hash needs
NDT_FLOPS_PER_PAIR = 283
GICP_FLOPS_PER_PAIR = 144
NN_FLOPS_PER_PAIR = 8
# K4 ranks every pair on the tensor cores: two passes of a depth-16 bf16
# product, 2 x 2 x 16 a pair. Its bound counts that work at the bf16 peak;
# the f32 count of its plain version is printed beside it for comparison.
NN_MMA_FLOPS_PER_PAIR = 64
K4_CUDA_CORE_MS = 0.4347  # K4's device ms a launch before the redesign
NDT_SRC = "toyslam_tpu_torch/csrc/ndt_kernels.cu"
NN_SRC = "toyslam_tpu_torch/csrc/nn_kernels.cu"
GICP_SRC = "toyslam_tpu_torch/csrc/gicp_kernels.cu"
RANK_SRC = "toyslam_tpu_torch/csrc/ranking_kernels.cu"
GATHER_SRC = "toyslam_tpu_torch/csrc/gather_kernels.cu"
EIGH3_SRC = "toyslam_tpu_torch/csrc/eigh3_kernels.cu"
# The eigensolver against its plain version (phase 2): N 384 and 768 (a
# LOAM edge and surface call), 32768 (a GICP covariance call), and the map
# build's [B, V, 6] components; timed at EIGH3_TIMED in float32.
EIGH3_SIZES = (384, 768, 32768)
EIGH3_MAP_SHAPE = (4, 65536)
EIGH3_TIMED = (768, 32768)
# Rounded operations a matrix, counted from csrc/eigh3_kernels.cu: 50 a
# rotation (3 divisions, 2 square roots) over 5 sweeps of 3, the 6
# scaling divisions and the 3 products that undo the scale.
EIGH3_FLOPS_PER_MATRIX = 50 * 15 + 6 + 3
EIGH3_BYTES_PER_MATRIX = (6 + 12) * 4  # float32: six read, twelve written
# D1's split modes against their plain version, of the largest |s.t|: the
# same exact bf16 products, summed by the tensor core in place of f32 adds
# in order (a bf16-level sum would miss by ~2^-9).
SPLIT_RTOL = 2.0 ** -16
# K4's margin assumes the tensor core misses the exact sum of its bf16
# products by at most this share of their magnitudes (csrc/nn_kernels.cu).
MMA_SUM_RTOL = 2.0 ** -17
D1_FLOPS_PER_ENTRY = {"highest": 5, "bf16": 6, "3pass": 20, "concat6": 12,
                      "concat9": 18}  # 2 K (+ 2 adds for 3pass)
KERNELS = {  # name -> (source, Pallas kernel it replaces)
    "ndt_terms_gathered": (NDT_SRC, "toyslam_tpu/ops/ndt_pallas.py:271"),
    "ndt_gather_repack": (NDT_SRC, "toyslam_tpu/ops/ndt_pallas.py:323"),
    "ndt_terms_packed": (NDT_SRC, "toyslam_tpu/ops/ndt_pallas.py:355"),
    "nearest_neighbor": (NN_SRC, "toyslam_tpu/ops/nn_pallas.py:197"),
    "neg_dist_bf16": (NN_SRC, "toyslam_tpu/ops/nn_pallas.py:152"),
    "gicp_terms": (GICP_SRC, "toyslam_tpu/ops/gicp_pallas.py:104"),
    # No Pallas kernel: the jnp solve and pose update of the GN step.
    "gicp_update": (GICP_SRC, "toyslam_tpu/registration/gicp.py:327-330"),
    "split_dot": (RANK_SRC, "benchmarks/diag_bf16_concat.py:37"),
    "lane_row_sum": (GATHER_SRC, "benchmarks/profile_gather_modes.py:136"),
    # No Pallas kernel: the jnp Jacobi solver, which XLA fuses.
    "eigh3": (EIGH3_SRC, "toyslam_tpu/ops/eigh3.py:29-86"),
}
# The CUDA function each kernel launches, as the profiler names it.
CUDA_NAMES = {
    "ndt_terms_gathered": "terms_gathered_kernel",
    "ndt_gather_repack": "gather_repack_kernel",
    "ndt_terms_packed": "terms_packed_kernel",
    "nearest_neighbor": "nearest_kernel",
    "neg_dist_bf16": "neg_dist_kernel",
    "gicp_terms": "gicp_terms_kernel",
    "gicp_update": "gicp_update_kernel",
    "lane_row_sum": "lane_row_sum_kernel",
    "eigh3": "eigh3_kernel",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS):
    """Mean milliseconds per call on the card (CUDA events, after one
    warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps=5):
    """Mean host-clock milliseconds per call, each closed by a sync."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.mean(times)), out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, peak=PEAK_F32_FLOPS):
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def count_syncs(fn):
    """Runs fn with PyTorch's sync debug mode on; returns (result, {line of
    the port that led to it: synchronising calls reported there})."""
    import torch

    import toyslam_tpu_torch

    pkg = str(Path(toyslam_tpu_torch.__file__).resolve().parent)
    where = {}

    def record(message, category, filename, lineno, *rest):
        # (sync debug mode's own notice, "... does not yet detect all
        # synchronizing operations", is not a sync)
        if "synchroniz" not in str(message) or "debug mode" in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if str(Path(f.filename).resolve()).startswith(pkg)]
        f = ours[-1] if ours else None
        key = (f"{'/'.join(Path(f.filename).parts[-2:])}:{f.lineno}" if f
               else f"{'/'.join(Path(filename).parts[-2:])}:{lineno}")
        where[key] = where.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, where


def device_profile(fn, top=6):
    """One call of fn under torch.profiler: (wall ms, device busy ms,
    launches, [(kernel, calls, device ms)] of the top kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[2])
    return (wall, sum(r[2] for r in rows), sum(r[1] for r in rows),
            rows[:top])


def device_ms_per_launch(fn, kernel, reps=REPS, sessions=3):
    """Device milliseconds per launch of the CUDA function whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of fn after one
    warm-up call (the wrapper's host work is not in it). Now and then a
    profiler session on the card reports no device events at all; such a
    session is run again, up to ``sessions`` in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key]
        calls = sum(c for c, _ in rows)
        if calls > 0:
            return sum(t for _, t in rows) / 1e3 / calls
    raise SmokeFailure(f"the profiler saw no launch of {kernel} in "
                       f"{sessions} sessions")


def host_wait_ms(fn, spin_ms=50.0):
    """Host milliseconds that fn takes while the card spins for spin_ms on
    work queued before it: about spin_ms if fn waits on the device
    (a sync hidden in a library call), a fraction of it if not."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = int(10_000_000 * spin_ms / start.elapsed_time(end))
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    fn()
    waited = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return waited


def one_lane(ndt_map, src, cfg, p):
    """The NDT evaluator of one source at one lane (``ndt._single_lane``)
    and its one-lane operands at host pose p: the evaluator, its points
    [3, N], mask, offsets, 1 / leaf and K as ``one``, the [83] parameters
    and the plain neighbour hash (h, nvid, okm) there."""
    from types import SimpleNamespace

    from toyslam_tpu_torch.ops import ndt_kernels
    from toyslam_tpu_torch.registration import ndt

    d1, d2, _ = ndt.gauss_coefficients(cfg.resolution, cfg.outlier_ratio)
    ev = ndt._single_lane(ndt_map, src.xyzi[:, :3], src.mask,
                          cfg.resolution, ndt._OFFSETS[cfg.search_method],
                          d1, d2)
    one = SimpleNamespace(xyz=ev.xyz[0], mask=ev.mask[0], offsets=ev.offsets,
                          inv_leaf=ev.inv_leaf, K=ev.K)
    params = ev.params([p])[0]
    hashed = ndt_kernels.ndt_neighbor_hash_plain(
        params, one.xyz, one.mask, ndt_map.min_b, ndt_map.div,
        ndt_map.hash_table.shape[0], ev.inv_leaf, ev.offsets)
    return ev, one, params, hashed


def terms_err(got, want, groups):
    """Max error of the sums, each relative to the largest of its group."""
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    worst, abs_err = 0.0, 0.0
    for sl in groups:
        diff = np.abs(got[sl] - want[sl])
        abs_err = max(abs_err, float(diff.max()))
        worst = max(worst, float(diff.max() / max(np.abs(want[sl]).max(),
                                                   1e-30)))
    return worst, abs_err


NDT_GROUPS = (slice(0, 1), slice(1, 7), slice(7, 28))
GN_GROUPS = (slice(0, 6), slice(6, 12), slice(12, 21), slice(21, 27))


def rotation_angle(Ra, Rb):
    """Angle between two rotations from ||Ra - Rb||_F = 2 sqrt(2) sin(a/2)
    (arccos of the trace loses small angles to rounding)."""
    s = np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0))
    return float(2.0 * np.arcsin(min(s, 1.0)))


def pose_diff(Ta, Tb):
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    return (float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])),
            rotation_angle(Ta[:3, :3], Tb[:3, :3]))


def golden_chain(clouds, ncfg):
    """The f64 golden NDT (``tests/golden_ndt.py``, exact pclomp control
    flow) chained over clouds [n, 3] f64 with the odometry's warm start:
    world positions [S, 3]."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import golden_ndt

    pose, prev_T = np.eye(4), np.eye(4)
    out = [pose[:3, 3].copy()]
    for k in range(1, len(clouds)):
        leaves, min_b, max_b, div = golden_ndt.build_map(clouds[k - 1],
                                                         ncfg.resolution)
        prev_T, _, _, _ = golden_ndt.align(
            leaves, min_b, max_b, div, clouds[k], cfg_res=ncfg.resolution,
            step_size=ncfg.step_size, eps=ncfg.transformation_epsilon,
            max_iter=ncfg.max_iterations, guess=prev_T)
        pose = pose @ prev_T
        out.append(pose[:3, 3].copy())
    return np.stack(out)


def voxel_means(cloud, leaf):
    """{voxel key: mean} of a map's valid rows; a mean lies in its own
    voxel, so floor(mean / leaf) names the voxel in either map."""
    pts = cloud.xyzi[cloud.mask].double().cpu().numpy()
    keys = np.floor(pts[:, :3] / leaf).astype(np.int64)
    return {tuple(k): p for k, p in zip(keys, pts)}


def run_module(module, *args):
    """``python -m <module> <args>`` from the repo root: (exit code,
    stdout, host seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          capture_output=True, text=True,
                          timeout=APP_TIMEOUT_S,
                          cwd=Path(__file__).resolve().parent)
    if proc.returncode not in (0, 1):
        raise SmokeFailure(f"{module} exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def run_app(*args):
    """``python -m toyslam_tpu_torch.apps.mapping_demo`` from the repo
    root: (stdout, the map's point count it printed)."""
    rc, stdout, _ = run_module("toyslam_tpu_torch.apps.mapping_demo", *args)
    check(rc == 0, f"mapping_demo {args[2:]} exited {rc}")
    return stdout, int(re.search(r"map\.pcd \((\d+) pts\)",
                                 stdout).group(1))


def mapping_path(scans, scan_mask, xyzi, mask, cfg, odo_out, a_xyzi,
                 a_mask):
    """Phases 12-18: the mapping slice on the card. Returns the kernels'
    launch counts of the mapping run, phase 17's reader, and phase 18's
    batch files (trajectory.txt, solution.csv, map.pcd bytes)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from toyslam_tpu_torch.core import pcd_io, pointcloud
    from toyslam_tpu_torch.diag import ndt_odometry_edge
    from toyslam_tpu_torch.ops import eigh3_kernels, ndt_kernels
    from toyslam_tpu_torch.pipelines import odometry
    from toyslam_tpu_torch.registration import ndt
    from toyslam_tpu_torch.utils import checkpoint, evalio

    S = scans.shape[0]
    mcfg = cfg._replace(keep_intensity=True)

    # 12. ndt_mapping at full width, counts reset just before it.
    ndt_kernels.reset_launch_counts()
    eigh3_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mout = odometry.ndt_mapping(scans, scan_mask, MAP_CAPACITY, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    map_launch = {**ndt_kernels.LAUNCHES, **eigh3_kernels.LAUNCHES}
    t0 = time.perf_counter()
    again = odometry.ndt_mapping(scans, scan_mask, MAP_CAPACITY, cfg)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    card = card_line()
    print(f"phase 12 mapping: ndt_mapping over the {S} odometry scans, "
          f"map capacity {MAP_CAPACITY} at {cfg.map_leaf} m; launches "
          f"{map_launch}; converged {mout.odometry.converged.tolist()}")
    check(map_launch["ndt_gather_repack"] > 0
          and map_launch["ndt_terms_packed"] > 0,
          "K2 or K3 was never launched in the mapping path")
    check(map_launch["eigh3"] == S - 1, "the mapping path did not launch "
                                        "eigh3 once a map build")
    check(bool(mout.odometry.converged.all()), "a mapping align did not "
                                               "converge")
    check(torch.equal(again.odometry.poses, mout.odometry.poses)
          and torch.equal(again.map_xyzi, mout.map_xyzi),
          "a mapping rerun differs")

    # 13. The poses against phase 4's odometry (keep_intensity off there).
    same = torch.equal(mout.odometry.poses, odo_out.poses)
    d_m = float((mout.odometry.poses.double()
                 - odo_out.poses.double())[:, :3, 3].abs().max())
    print(f"phase 13 mapping poses vs phase 4's odometry poses: "
          f"bit-identical {same} (max {d_m:.3g} m)")
    check(same, "mapping poses differ from the odometry poses")

    # 14. Stream: mapping_init + mapping_step, a checkpoint after scan 7;
    #     the map's voxel count after every scan.
    tmp = tempfile.TemporaryDirectory()
    ckpt = Path(tmp.name) / "state.npz"
    state = odometry.mapping_init(scans[0], scan_mask[0], MAP_CAPACITY, cfg)
    counts = [int(state.map_cloud.mask.sum())]
    poses, steps = [state.odometry.pose], []
    for i in range(1, S):
        steps.append((state.map_cloud, scans[i], scan_mask[i]))
        state, o = odometry.mapping_step(state, scans[i], scan_mask[i], cfg)
        poses.append(o[0])
        counts.append(int(state.map_cloud.mask.sum()))
        if i == CKPT_SCAN:
            checkpoint.save_checkpoint(ckpt, state)
    print(f"phase 14 stream: map voxels after each scan {counts} (capacity "
          f"{MAP_CAPACITY})")
    check(max(counts) < MAP_CAPACITY, "the map reached its capacity and "
                                      "dropped voxels")
    check(torch.equal(torch.stack(poses), mout.odometry.poses)
          and torch.equal(state.map_cloud.xyzi, mout.map_xyzi)
          and torch.equal(state.map_cloud.mask, mout.map_mask),
          "chained mapping_step differs from ndt_mapping")
    template = odometry.mapping_init(scans[0], scan_mask[0], MAP_CAPACITY,
                                     cfg)
    back = checkpoint.load_checkpoint(ckpt, template)
    check(back.map_cloud.xyzi.is_cuda and back.odometry.pose.device.type
          == "cpu" and back.map_cloud.mask.dtype == torch.bool,
          "a reloaded checkpoint lost its devices or dtypes")
    for i in range(CKPT_SCAN + 1, S):
        back, o = odometry.mapping_step(back, scans[i], scan_mask[i], cfg)
        check(torch.equal(o[0], mout.odometry.poses[i]),
              f"resumed pose {i} differs")
    check(torch.equal(back.map_cloud.xyzi, mout.map_xyzi)
          and torch.equal(back.map_cloud.mask, mout.map_mask),
          "the resumed map differs")
    tmp.cleanup()
    print(f"  chained steps equal ndt_mapping bit for bit (poses, map xyzi "
          f"and mask); resumed from the checkpoint after scan {CKPT_SCAN} "
          f"on the card: bit-identical")

    # Host syncs: the merge alone, and a mapping step against the same
    # scan's odometry step.
    map_prev, scan_k, mask_k = steps[-1]
    ds_k = odometry._downsample(scan_k, mask_k, mcfg)
    pose_k = mout.odometry.poses[S - 1]
    _, merge_syncs = count_syncs(lambda: odometry._merge_into_map(
        map_prev, ds_k, pose_k, mcfg))
    pre = odometry.MappingState(
        odometry.OdometryState(odometry._downsample(
            scans[S - 2], scan_mask[S - 2], mcfg),
            mout.odometry.poses[S - 2], mout.odometry.pairwise[S - 2]),
        map_prev)
    _, step_syncs = count_syncs(lambda: odometry.mapping_step(
        pre, scan_k, mask_k, cfg))
    _, odo_syncs = count_syncs(lambda: odometry.odometry_step(
        pre.odometry, scan_k, mask_k, mcfg))
    merge_wait = host_wait_ms(lambda: odometry._merge_into_map(
        map_prev, ds_k, pose_k, mcfg))
    merge_ms, _ = host_ms(lambda: odometry._merge_into_map(
        map_prev, ds_k, pose_k, mcfg))
    n_step, n_odo = sum(step_syncs.values()), sum(odo_syncs.values())
    print(f"  host syncs (sync debug mode): the merge alone {merge_syncs}; "
          f"a mapping step {n_step}, its odometry step {n_odo}; the merge "
          f"waits {merge_wait:.3f} ms while the card spins 50 ms")
    check(not merge_syncs and n_step == n_odo and merge_wait < 25.0,
          "the merge adds a host sync")
    wall, busy, n_ops, top = device_profile(lambda: odometry._merge_into_map(
        map_prev, ds_k, pose_k, mcfg))
    print(f"  torch.profiler, one merge: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, {n_ops} device operations; top by device time: "
          f"{[(key[:90], calls, round(ms, 4)) for key, calls, ms in top]}")
    print(f"  timings ({card}), host clock: ndt_mapping "
          f"{(S - 1) / map_s:.2f} scans/s ({1e3 * map_s / (S - 1):.2f} "
          f"ms/scan, second run; first run {(S - 1) / first_s:.2f}); the "
          f"merge {merge_ms:.3f} ms a scan (mean of 5, closed by a sync, "
          f"{int(map_prev.mask.sum())} map voxels + "
          f"{int(ds_k.mask.sum())} scan points)")

    # 15. The map on the card against the same merges on the CPU in f32,
    #     from the card's own poses and downsampled clouds.
    ds = [odometry._downsample(scans[k], scan_mask[k], mcfg)
          for k in range(S)]
    cpu_map = pointcloud.pad_to(pointcloud.voxel_downsample(
        pointcloud.PointCloud(ds[0].xyzi.cpu(), ds[0].mask.cpu()),
        cfg.map_leaf), MAP_CAPACITY)
    for k in range(1, S):
        cpu_map = odometry._merge_into_map(
            cpu_map, pointcloud.PointCloud(ds[k].xyzi.cpu(),
                                           ds[k].mask.cpu()),
            mout.odometry.poses[k], mcfg)
    card_vox = voxel_means(pointcloud.PointCloud(mout.map_xyzi,
                                                 mout.map_mask),
                           cfg.map_leaf)
    cpu_vox = voxel_means(cpu_map, cfg.map_leaf)
    matched = card_vox.keys() & cpu_vox.keys()
    differ = len(card_vox.keys() ^ cpu_vox.keys()) / len(
        card_vox.keys() | cpu_vox.keys())
    mean_err = max(float(np.abs(card_vox[k][:3] - cpu_vox[k][:3]).max())
                   for k in matched)
    bit_same = torch.equal(cpu_map.xyzi, mout.map_xyzi.cpu())
    print(f"phase 15 map on the card vs the CPU: {len(card_vox)} and "
          f"{len(cpu_vox)} voxels, {differ:.3%} differ (bound "
          f"{MAP_DIFFER_MAX:.1%}), largest mean difference over the "
          f"{len(matched)} matched {mean_err:.3g} m (bound {MAP_MEAN_TOL_M} "
          f"m); bit-identical {bit_same}")
    check(differ <= MAP_DIFFER_MAX and mean_err <= MAP_MEAN_TOL_M,
          "the card's map differs from the CPU's")

    # 16. Coarse-to-fine odometry, kernels and plain versions.
    c_cfg = cfg._replace(coarse_leaf=COARSE_LEAF)
    stages, real_align = [], ndt.ndt_align_lanes  # the steps' aligns

    def recording(*args, **kw):
        res = real_align(*args, **kw)
        stages.append(ndt.NDTResult(*(f[0] for f in res)))  # one lane
        return res

    ndt_kernels.reset_launch_counts()
    with mock.patch.object(ndt, "ndt_align_lanes", recording):
        c2f = odometry.ndt_odometry(scans[:COARSE_SCANS],
                                    scan_mask[:COARSE_SCANS], c_cfg)
    c_launch = dict(ndt_kernels.LAUNCHES)
    with ndt_odometry_edge.plain_route():
        c2f_plain = odometry.ndt_odometry(scans[:COARSE_SCANS],
                                          scan_mask[:COARSE_SCANS], c_cfg)
    summed = [int(a.evaluations + b.evaluations)
              for a, b in zip(stages[::2], stages[1::2])]
    cp, pp = c2f.poses.double().numpy(), c2f_plain.poses.double().numpy()
    c_dt = float(np.abs(cp[:, :3, 3] - pp[:, :3, 3]).max())
    c_dr = max(rotation_angle(a[:3, :3], b[:3, :3]) for a, b in zip(cp, pp))
    print(f"phase 16 coarse-to-fine odometry (coarse leaf {COARSE_LEAF} m, "
          f"fine regather {c_cfg.fine_regather}) over {COARSE_SCANS} scans: "
          f"launches {c_launch}; evaluations {c2f.evaluations.tolist()} "
          f"(coarse + fine {summed}); kernels vs plain {c_dt:.3g} m, "
          f"{c_dr:.3g} rad (bounds {PAIRS_TOL_M} m, {PAIRS_TOL_RAD} rad)")
    check(bool(c2f.converged.all()) and bool(c2f_plain.converged.all())
          and all(bool(r.converged) for r in stages),
          "a coarse-to-fine align did not converge")
    check(len(stages) == 2 * (COARSE_SCANS - 1)
          and c2f.evaluations[1:].tolist() == summed,
          "coarse-to-fine evaluations are not coarse + fine")
    check(c_dt <= PAIRS_TOL_M and c_dr <= PAIRS_TOL_RAD,
          "coarse-to-fine kernels and plain versions disagree")

    # 17. The golden chain: the drifting 64-scan sequence of the JAX
    #     package's long-sequence parity test, on the align-65k scene.
    scene = a_xyzi[0][a_mask[0]]
    rng = np.random.default_rng(0)
    g_xyzi = np.zeros((GOLDEN_SCANS, len(scene), 4), np.float32)
    for k in range(GOLDEN_SCANS):
        c = scene.copy()
        c[:, 0] -= 0.3 * k
        c[:, 1] -= 0.1 * k
        c[:, :3] += rng.normal(0, 0.01, (len(c), 3)).astype(np.float32)
        g_xyzi[k] = c
    g_scans = torch.from_numpy(g_xyzi).to(scans.device)
    g_mask = torch.ones(g_scans.shape[:2], dtype=torch.bool,
                        device=scans.device)
    t0 = time.perf_counter()
    gout = odometry.ndt_mapping(g_scans, g_mask, MAP_CAPACITY, cfg)
    torch.cuda.synchronize()
    g_card_s = time.perf_counter() - t0
    check(bool(gout.odometry.converged.all()), "a golden-sequence align "
                                               "did not converge")

    def clouds(stack, stack_mask):
        out = []
        for k in range(stack.shape[0]):
            d = odometry._downsample(stack[k], stack_mask[k], mcfg)
            out.append(d.xyzi[d.mask][:, :3].double().cpu().numpy())
        return out

    # The f64 golden chains take ~75 s of host: they run in a process of
    # their own while phases 18-24 use the card, and are read after them.
    jax_grid = cfg._replace(ndt=cfg.ndt._replace(grid_capacity=1 << 15))
    jpos = odometry.ndt_mapping(g_scans, g_mask, MAP_CAPACITY, jax_grid)
    ncfg = cfg.ndt
    inputs = {f"g{k}": c for k, c in enumerate(clouds(g_scans, g_mask))}
    inputs.update({f"o{k}": c for k, c in enumerate(clouds(scans,
                                                            scan_mask))})
    inputs["ndt"] = np.array([ncfg.resolution, ncfg.step_size,
                              ncfg.transformation_epsilon,
                              ncfg.max_iterations])
    job = HostJob("golden", inputs)
    est = gout.odometry.poses.double().numpy()[:, :3, 3]
    jest = jpos.odometry.poses.double().numpy()[:, :3, 3]
    est256 = odo_out.poses.double().numpy()[:, :3, 3]

    def golden_phase():
        gold, gold256 = job.get()["g"], job.get()["o"]
        g_rmse, _ = evalio.ate(est, gold, align=True)
        g_max = float(np.linalg.norm(est - gold, axis=1).max())
        print(f"phase 17 golden chain (read now; the host ran it during "
              f"phases 18-24): {GOLDEN_SCANS} scans of the align-65k scene "
              f"({len(scene)} points, shifted -0.3/-0.1 m a scan, 1 cm "
              f"noise), ndt_mapping on the card {g_card_s:.2f} s, the f64 "
              f"golden chain on the host {float(job.get()['g_s']):.1f} s: "
              f"ATE aligned rmse {g_rmse:.4g} m (bound {GOLDEN_RMSE_M}), "
              f"unaligned max {g_max:.4g} m (bound {GOLDEN_MAX_M})")
        check(g_rmse < GOLDEN_RMSE_M and g_max < GOLDEN_MAX_M,
              "the card's trajectory is far from the f64 golden chain")
        # The JAX package's grid (1 << 15), for the record: its hash
        # aliasing is why the port's default differs (pipelines/odometry.
        # OdometryConfig).
        print(f"  not gated: at the JAX package's grid_capacity 1 << 15, "
              f"aligned rmse {evalio.ate(jest, gold, align=True)[0]:.4g} m, "
              f"unaligned max {np.linalg.norm(jest - gold, axis=1).max():.4g}"
              f" m")
        r256, _ = evalio.ate(est256, gold256, align=True)
        e256 = np.linalg.norm(est256 - gold256, axis=1)
        print(f"  odometry-256k vs its golden chain (not gated; scan 10 is "
              f"an edge of the data; {float(job.get()['o_s']):.1f} s): "
              f"aligned rmse {r256:.4g} m, unaligned max {e256.max():.4g} m "
              f"at scan {int(e256.argmax())}, per scan "
              f"{np.round(e256, 5).tolist()}")

    # 18. The app end to end: 6 scans as PCDs, batch and stream with
    #     checkpoints (two processes at once), resume.
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    (root / "scans").mkdir()
    for k in range(APP_SCANS):
        pcd_io.write_pcd(root / "scans" / f"cloud_{k}.pcd", xyzi[k][mask[k]])
    common = ("--capacity", xyzi.shape[1])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        batch = ex.submit(run_app, root / "scans", root / "batch", *common)
        stream = ex.submit(run_app, root / "scans", root / "stream", *common,
                           "--stream", "--checkpoint-every", 2)
        outs = {"batch": batch.result(), "stream": stream.result()}
    (root / "resume").mkdir()
    (root / "resume" / "mapping_state.npz").write_bytes(
        (root / "stream" / "mapping_state.npz").read_bytes())
    outs["resume"] = run_app(root / "scans", root / "resume", *common,
                             "--stream", "--resume")
    app_s = time.perf_counter() - t0
    check("resumed from" in outs["resume"][0], "the app did not resume")
    files = {name: [(root / name / f).read_bytes()
                    for f in ("trajectory.txt", "solution.csv", "map.pcd")]
             for name in outs}
    n_map = {name: len(pcd_io.read_pcd(root / name / "map.pcd"))
             for name in outs}
    print(f"phase 18 mapping_demo on {APP_SCANS} scans ({app_s:.1f} s for "
          f"three processes, the first two at once): map points printed "
          f"{ {k: v[1] for k, v in outs.items()} }, read back {n_map}; "
          f"stream and resume files equal to batch: "
          f"{files['stream'] == files['batch']}, "
          f"{files['resume'] == files['batch']}")
    check(files["stream"] == files["batch"]
          and files["resume"] == files["batch"],
          "the app's batch, stream and resume outputs differ")
    check(all(n_map[k] == outs[k][1] for k in outs),
          "map.pcd does not hold the printed point count")
    tmp.cleanup()
    return map_launch, golden_phase, files["batch"]


def distinct(d2, tol):
    """[Q, k] mask of entries more than tol from both neighbours in their
    row (where a ranking cannot swap)."""
    import torch

    gap = (d2[:, 1:] - d2[:, :-1]).abs() > tol
    ok = torch.ones_like(d2, dtype=torch.bool)
    ok[:, 1:] &= gap
    ok[:, :-1] &= gap
    return ok


def gicp_pair_terms(params, xyz, q, m6, w):
    """The plain per-correspondence terms [27, N] behind one K6 call (the
    terms that ``gicp_terms_plain`` sums)."""
    import torch

    from toyslam_tpu_torch.core import se3
    from toyslam_tpu_torch.ops import gicp_kernels as g

    R = params[:9].reshape(3, 3)
    Rp = (R @ xyz).T
    r = Rp + params[9:12] - q.T
    M = m6[g._SYM].T.reshape(-1, 3, 3)
    Mr = (M @ r[:, :, None])[..., 0]
    S = se3.skew(Rp)
    w1, w3 = w[:, None], w[:, None, None]
    iu, ju = g._UPPER
    return torch.cat([Mr * w1, torch.linalg.cross(Rp, Mr) * w1,
                      (w3 * M)[:, iu, ju],
                      (w3 * (M @ S.transpose(1, 2))).reshape(-1, 9),
                      (w3 * (S @ M @ S.transpose(1, 2)))[:, iu, ju]], 1).T


def kernel_err(name, args, got, want):
    """(error, within its bound) of a kernel's output against its plain
    version's on the same inputs: K2 and K4 bit for bit, K5 within 1 bf16
    ulp on NN_SHARE of the valid columns' entries (a column is valid where
    its |t|^2 is below the sentinel), ``gicp_update`` within
    UPDATE_STEP_RTOL of its plain step plus UPDATE_ULPS ulps (the error is
    its largest absolute one), K1, K3 and K6 within TERMS_MAG_RTOL
    of the magnitudes of each sum's terms. Along a path the sums are
    taken near an optimum too, where a gradient cancels to far below its
    terms; an error relative to the largest sum of a group (phase 7's
    check at the identity guess) then measures the cancellation, not the
    kernel. The error is (relative to the group's largest, relative to
    the magnitudes)."""
    import torch

    from toyslam_tpu_torch.diag import ndt_odometry_edge

    if name == "nearest_neighbor":
        (best, idx), (pbest, pidx) = got, want
        same = torch.equal(idx, pidx) and torch.equal(
            best.view(torch.int32), pbest.view(torch.int32))
        return float((best - pbest).abs().max()), same
    if name == "ndt_gather_repack":
        return (float((got - want).abs().max()),
                torch.equal(got.view(torch.int32), want.view(torch.int32)))
    if name == "neg_dist_bf16":
        nd, pd, cols = got.float(), want.float(), args[3] < 1e8
        diff = (nd - pd)[:, cols]
        share = float((diff.abs() <= 2.0 ** -8 * pd[:, cols].abs())
                      .double().mean())
        return float(diff.abs().max()), share >= NN_SHARE
    if name == "gicp_update":
        params = args[1]
        step = float((want - params).abs().max())
        ulp = 2.0 ** -23 * max(1.0, float(params.abs().max()))
        diff = float((got - want).abs().max())
        return diff, diff <= UPDATE_STEP_RTOL * step + UPDATE_ULPS * ulp
    if name == "gicp_terms":
        rel, _ = terms_err(got, want, GN_GROUPS)
        terms = gicp_pair_terms(*args)
    else:
        rel, _ = terms_err(got, want, NDT_GROUPS)
        terms = ndt_odometry_edge._pair_terms(name, args)
    mag = ndt_odometry_edge.magnitude_err(got, want, terms)
    return (rel, mag), mag <= TERMS_MAG_RTOL


def checked_plain_route(calls):
    """K1-K6's wrappers, and K1's and K3's lane wrappers, replaced by their
    plain versions while the block runs; each call also runs the kernel on
    the same inputs and appends (name, points, error, within bound,
    bit-identical to the one-lane launches) to ``calls``: every kernel
    held to its plain version at the shapes the path gives it. A lane call
    (name ``*_lanes``, points its L rows) holds each row to the plain row
    and to the one-lane kernel launched on that row's lane; its error is
    the worst row's. One-lane calls append None as the last."""
    from contextlib import ExitStack

    import torch

    from toyslam_tpu_torch.diag import ndt_odometry_edge
    from toyslam_tpu_torch.diag.ndt_odometry_edge import lane_row_args
    from toyslam_tpu_torch.ops import gicp_kernels, ndt_kernels, nn_kernels

    def checked(mod, name):
        kernel, plain = getattr(mod, name), getattr(mod, name + "_plain")

        def run(*args):
            want = plain(*args)
            got = kernel(*args)
            rows = (args[0].shape[0] if mod is nn_kernels
                    else 1 if name == "gicp_update"  # one 6x6 system
                    else max(args[1].shape))  # the points, either layout
            calls.append((name, rows, *kernel_err(name, args, got, want),
                          None))
            return want
        return run

    def checked_lanes(name):
        kernel = getattr(ndt_kernels, name + "_lanes")
        one_lane = getattr(ndt_kernels, name)  # before the patches below

        def run(*args):
            # The plain rows are the sums of the plain per-pair terms
            # (``ndt_terms_*_lanes_plain``, bit for bit); the terms also
            # give each sum's magnitudes, as ``kernel_err`` takes them.
            got = kernel(*args)
            ones = [lane_row_args(name, args, y, b) for y, b in
                    enumerate(ndt_kernels.lane_list(args[1], args[-1]))]
            terms = [ndt_odometry_edge._pair_terms(name, one) for one in ones]
            want = torch.stack([t.sum(1) for t in terms])
            alone = torch.stack([one_lane(*one) for one in ones])
            scale = torch.stack([t.double().abs().sum(1) for t in terms])
            diff = (got.double() - want.double()).abs()
            mag = float((diff / scale.clamp_min(1e-300)).max())
            rel = max(float((diff[:, sl].amax(1) / want[:, sl].double().abs()
                             .amax(1).clamp_min(1e-30)).max())
                      for sl in NDT_GROUPS)
            calls.append((name + "_lanes", len(want), (rel, mag),
                          mag <= TERMS_MAG_RTOL, torch_equal_bits(got, alone)))
            return want
        return run

    stack = ExitStack()
    for name in ("ndt_terms_gathered", "ndt_terms_packed"):
        stack.enter_context(mock.patch.object(
            ndt_kernels, name + "_lanes", checked_lanes(name)))
    for mod in (ndt_kernels, nn_kernels, gicp_kernels):
        for name in mod.LAUNCHES:
            stack.enter_context(mock.patch.object(mod, name,
                                                  checked(mod, name)))
    return stack


def align_app_kernels(s_ds, t_ds):
    """Phase 19's second part: each of the align app's methods on the
    app's own clouds (at most CAPACITY voxels), from the identity guess,
    through the kernels and through the checked plain route; the kernels
    held to plain at every call along the plain route and the two poses
    within the kernel-vs-plain bounds of phases 4 and 8."""
    import torch

    from toyslam_tpu_torch.apps import align

    bounds = {"ICP": (ICP_TOL_M, ICP_TOL_RAD),
              "GICP": (GICP_TOL_M, GICP_TOL_RAD)}
    wants = {"ICP": {"nearest_neighbor"},
             "GICP": {"nearest_neighbor", "neg_dist_bf16", "gicp_terms",
                      "gicp_update"}}
    print(f"  kernels vs plain along the app's aligns (N "
          f"{s_ds.capacity}, M {t_ds.capacity}, {int(s_ds.mask.sum())} and "
          f"{int(t_ds.mask.sum())} valid points), from the identity:")
    for method, run in align.aligners(s_ds, t_ds).items():
        res = run(torch.eye(4))
        calls = []
        with checked_plain_route(calls):
            plain = run(torch.eye(4))
        tol_m, tol_rad = bounds.get(method, (PAIRS_TOL_M, PAIRS_TOL_RAD))
        d_t, d_r = pose_diff(res.transform, plain.transform)
        seen = {}
        for name, rows, e, ok, _ in calls:
            n, worst, good, shapes = seen.get(name, (0, None, True, set()))
            worst = e if worst is None else (
                tuple(map(max, worst, e)) if isinstance(e, tuple)
                else max(worst, e))
            seen[name] = (n + 1, worst, good and ok, shapes | {rows})
        per_kernel = "; ".join(
            f"{k} {n} calls at rows {sorted(r)}, " + (
                f"max err {w[0]:.3g} of the group's largest sum, {w[1]:.3g} "
                f"of the terms' magnitudes (bound {TERMS_MAG_RTOL:.3g})"
                if isinstance(w, tuple) else f"max abs err {w:.3g}")
            + f", within bound {g}" for k, (n, w, g, r) in seen.items())
        print(f"    {method}: poses {d_t:.3g} m, {d_r:.3g} rad apart "
              f"(bounds {tol_m} m, {tol_rad} rad), converged "
              f"{res.converged} and {plain.converged}; {per_kernel}")
        check(res.converged and plain.converged,
              f"align app kernels: {method} did not converge on both routes")
        check(d_t <= tol_m and d_r <= tol_rad,
              f"align app kernels: {method}'s kernel and plain routes "
              "disagree")
        check(wants.get(method, {"ndt_terms_gathered_lanes"}) <= set(seen),
              f"align app kernels: {method} did not reach its kernels")
        check(all(v[2] for v in seen.values()),
              f"align app kernels: a kernel of {method} disagrees with its "
              "plain version at the app's shapes")


def align_app_phase(dev, a_xyzi, a_mask, a_gt):
    """Phase 19: the align app on the align-65k pair. Returns the app's
    launches by kernel, and its clouds on the card with NDT DIRECT7's
    pose for phase 20."""
    import torch

    from toyslam_tpu_torch.apps import align
    from toyslam_tpu_torch.core import pcd_io, pointcloud
    from toyslam_tpu_torch.registration import ndt

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    for k, name in ((0, "target.pcd"), (1, "source.pcd")):
        pcd_io.write_pcd(root / name, a_xyzi[k][a_mask[k]])
    rc, stdout, app_s = run_module("toyslam_tpu_torch.apps.align",
                                   root / "target.pcd", root / "source.pcd",
                                   "--json")
    check(rc == 0, f"the align app exited {rc}")
    rep = json.loads(stdout.strip().splitlines()[-1])
    print(f"phase 19 align app on the align-65k pair ({app_s:.1f} s, one "
          f"process): {rep['voxels']} voxels at {align.LEAF} m, "
          f"{rep['cut']} cut by the capacity; {rep['card']}")
    pts = [pcd_io.read_pcd(root / n) for n in ("target.pcd", "source.pcd")]
    cap = max(len(p) for p in pts)
    t_ds, s_ds = (pointcloud.voxel_downsample(
        pointcloud.from_numpy(p, capacity=cap, device=dev), align.LEAF,
        min(align.CAPACITY, cap)) for p in pts)
    a_rel = np.linalg.inv(a_gt[0]) @ a_gt[1]
    truth_t, _ = pose_diff(a_rel, np.eye(4))
    wants = {"ICP": ("nearest_neighbor",),
             "GICP": ("nearest_neighbor", "neg_dist_bf16", "gicp_terms",
                      "gicp_update", "eigh3")}
    app_launch = dict.fromkeys(NEW_PATH_KERNELS, 0)
    for m in rep["methods"]:
        T = torch.tensor(m["transform"], dtype=torch.float32)
        direct = float(ndt.fitness_score(s_ds, t_ds, T))
        e_t, e_r = pose_diff(T, a_rel)
        print(f"  {m['method']}: {m['ms_per_align']:.3f} ms/align (median "
              f"of 3 batches of {rep['reps']}: "
              f"{[round(x, 3) for x in m['batch_ms_per_align']]}), fitness "
              f"{m['fitness']:.6f} (direct call {direct:.6f}), converged "
              f"{m['converged']}, vs ground truth {e_t:.4g} m, {e_r:.4g} rad "
              f"(identity {truth_t:.4g} m); launches {m['launches']}")
        check(m["converged"], f"align app: {m['method']} did not converge")
        check(e_t < truth_t, f"align app: {m['method']} did not improve on "
                             "its identity guess")
        check(m["fitness"] == direct, f"align app: {m['method']}'s fitness "
                                      "differs from fitness_score")
        for name in wants.get(m["method"], ("ndt_terms_gathered",)):
            check(m["launches"].get(name, 0) > 0,
                  f"align app: {m['method']} never launched {name}")
        for name, n in m["launches"].items():
            app_launch[name] += n
    align_app_kernels(s_ds, t_ds)

    tmp.cleanup()
    T = torch.tensor(rep["methods"][2]["transform"], dtype=torch.float32)
    return app_launch, (s_ds, t_ds, T)


def search_phase(dev, s_ds, t_ds, T):
    """Phase 20: the NDT search helpers on the align app's clouds, on the
    card, against the plain route and the CPU."""
    import torch

    from toyslam_tpu_torch.core import pointcloud
    from toyslam_tpu_torch.ops import nn_kernels
    from toyslam_tpu_torch.registration import ndt

    nn_kernels.reset_launch_counts()
    fit = ndt.fitness_score(s_ds, t_ds, T)
    k4_calls = nn_kernels.LAUNCHES["nearest_neighbor"]
    with mock.patch.object(nn_kernels, "nearest_neighbor",
                           nn_kernels.nearest_neighbor_plain):
        fit_plain = ndt.fitness_score(s_ds, t_ds, T)
    t_cpu = pointcloud.PointCloud(t_ds.xyzi.double().cpu(), t_ds.mask.cpu())
    s_cpu = pointcloud.PointCloud(s_ds.xyzi.double().cpu(), s_ds.mask.cpu())
    t0 = time.perf_counter()
    num = den = 0.0
    for i in range(0, s_cpu.capacity, 2048):  # row chunks bound the memory
        chunk = pointcloud.PointCloud(s_cpu.xyzi[i:i + 2048],
                                      s_cpu.mask[i:i + 2048])
        n = int(chunk.mask.sum())
        if n:
            num += float(ndt.fitness_score(chunk, t_cpu, T.double())) * n
            den += n
    fit64 = num / den
    fit_ms = cuda_ms(lambda: ndt.fitness_score(s_ds, t_ds, T))
    fit_rel = abs(float(fit) - fit64) / fit64
    print(f"phase 20 search helpers at align-65k on the card: fitness_score "
          f"{float(fit):.7f} through K4 ({k4_calls} launch, {fit_ms:.3f} ms "
          f"a call), plain route equal: {torch.equal(fit, fit_plain)}; f64 "
          f"on the CPU {fit64:.9f} ({time.perf_counter() - t0:.1f} s), "
          f"relative {fit_rel:.3g} (bound {FIT64_RTOL})")
    check(k4_calls == 1 and torch.equal(fit, fit_plain),
          "fitness_score through K4 differs from its plain route")
    check(fit_rel <= FIT64_RTOL, "fitness_score far from the f64 result")

    amap = ndt.build_ndt_map(t_ds, ndt.NDTConfig(resolution=1.0))
    cmap = ndt.NDTMap(*(x.cpu() for x in amap))
    q = (s_ds.xyzi[:SEARCH_QUERIES, :3] @ T[:3, :3].T.to(dev)
         + T[:3, 3].to(dev)).contiguous()
    qc = q.cpu()
    same_lookup = True
    for method in ("DIRECT1", "DIRECT7", "DIRECT27"):
        off = ndt._OFFSETS[method]
        slot, found = ndt.lookup_neighbors(amap, q, 1.0, off)
        cslot, cfound = ndt.lookup_neighbors(cmap, qc, 1.0, off)
        same_lookup &= (torch.equal(found.cpu(), cfound)
                        and torch.equal(slot.cpu(), cslot))
    idx, d2, kfound = ndt.nearest_k_search(amap, q, 8)
    cidx, cd2, ckfound = ndt.nearest_k_search(cmap, qc, 8)
    ridx, rd2, rfound, rcount = ndt.radius_search(amap, q, 2.0, 16)
    cridx, crd2, crfound, crcount = ndt.radius_search(cmap, qc, 2.0, 16)
    # |q|^2 + |c|^2 of every (query, voxel), the scale of the bound.
    scale = ((qc * qc).sum(1, keepdim=True)
             + (cmap.mean3 * cmap.mean3).sum(0)[None])
    k_scale = torch.take_along_dim(scale, cidx.long(), 1)
    r_scale = torch.take_along_dim(scale, cridx.long(), 1)
    k_rel = float(((d2.cpu() - cd2).abs() / k_scale).max())
    both = rfound.cpu() & crfound
    r_rel = float(torch.where(both, (rd2.cpu() - crd2).abs() / r_scale,
                              0.0).max())
    tol_row = 2 * SEARCH_D2_RTOL * scale.amax(1, keepdim=True)
    sure = distinct(cd2, tol_row) & ckfound
    k_sets = torch.equal(idx.cpu()[sure], cidx[sure])
    # Counts may differ only where a distance lies within the bound of r^2.
    full = ndt._centroid_sqdist(cmap, qc)
    edge = ((full - 4.0).abs() <= SEARCH_D2_RTOL * scale).any(1)
    count_ok = bool(((rcount.cpu() == crcount) | edge).all())
    r_sure = distinct(crd2, tol_row) & both
    r_sets = torch.equal(ridx.cpu()[r_sure], cridx[r_sure])
    print(f"  lookup_neighbors (DIRECT1/7/27, {SEARCH_QUERIES} queries) "
          f"equal to the CPU's: {same_lookup}; nearest_k_search k 8: "
          f"squared distances vs the CPU's f32 max {k_rel:.3g} of |q|^2 + "
          f"|c|^2 (bound {SEARCH_D2_RTOL:.3g}; max |q|^2 + |c|^2 "
          f"{float(scale.max()):.1f} m^2), indices equal on the "
          f"{int(sure.sum())} of {sure.numel()} entries with distinct "
          f"distances: {k_sets}; radius_search r 2 m, 16 kept: max "
          f"{r_rel:.3g}, counts equal off the r^2 edge: {count_ok} (mean "
          f"count {float(crcount.double().mean()):.1f}, "
          f"{int(edge.sum())} rows at the edge), indices equal where "
          f"distinct: {r_sets}")
    check(same_lookup, "lookup_neighbors on the card differs from the CPU")
    check(k_rel <= SEARCH_D2_RTOL and r_rel <= SEARCH_D2_RTOL and k_sets
          and r_sets and count_ok and torch.equal(kfound.cpu(), ckfound),
          "the centroid searches on the card differ from the CPU's")


def icp_slam_phase(dev):
    """Phase 21: the icp_demo app at its defaults, then icp_slam on its
    scenario through K4 and through the plain route. Returns K4's
    launches in the kernel run."""
    import torch

    from toyslam_tpu_torch.apps import icp_demo
    from toyslam_tpu_torch.ops import nn_kernels
    from toyslam_tpu_torch.pipelines import icp_slam

    tmp = tempfile.TemporaryDirectory()
    rc, stdout, app_s = run_module("toyslam_tpu_torch.apps.icp_demo",
                                   tmp.name)
    rep = json.loads(stdout.strip().splitlines()[-1])
    print(f"phase 21 icp_demo at its defaults ({app_s:.1f} s with the "
          f"process start): exit {rc}, {rep}")
    check(rc == 0 and rep["ate_rmse_m"] < 0.1, "icp_demo failed its gate")
    tmp.cleanup()
    xyzi, mask, gt, cap = icp_demo.scenario(10, 2000, 0, (0.12, 0.05, 0.0))
    scans = torch.from_numpy(xyzi).to(dev)
    masks = torch.from_numpy(mask).to(dev)
    cfg = icp_slam.IcpSlamConfig(map_capacity=4 * cap, map_leaf=0.3)
    nn_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = icp_slam.icp_slam(scans, masks, cfg)
    torch.cuda.synchronize()
    slam_s = time.perf_counter() - t0
    k4 = nn_kernels.LAUNCHES["nearest_neighbor"]
    with mock.patch.object(nn_kernels, "nearest_neighbor",
                           nn_kernels.nearest_neighbor_plain):
        plain = icp_slam.icp_slam(scans, masks, cfg)
    same = (torch.equal(out.poses, plain.poses)
            and torch.equal(out.map_xyzi, plain.map_xyzi))
    ate = float(np.sqrt(np.mean(np.sum(
        (out.poses.double().numpy()[:, :3, 3] - gt[:, :3, 3]) ** 2, 1))))
    print(f"  icp_slam in-process: {slam_s:.3f} s, K4 launches {k4}, ICP "
          f"iterations (= host syncs) {out.iterations.tolist()}, ATE "
          f"{ate:.5f} m; poses and map through K4 equal to the plain "
          f"route's: {same}")
    check(k4 == int(out.iterations.sum()) and k4 > 0,
          "icp_slam did not launch K4 once an ICP iteration")
    check(same, "icp_slam through K4 differs from the plain route")
    return {"nearest_neighbor": k4}


def imu_log(num_scans, seed=0):
    """A numpy-seeded IMU log of the generator's motion in the frame of
    scan 0: 3 m/s along the heading turning at 0.04 rad/s (0.3 m and
    0.004 rad a scan at 10 Hz), level: specific force [0, v w, g] and
    rate [0, 0, w] in the body frame, with FusionConfig's noise (0.03,
    0.002). Returns (acc, gyro, dt) f64."""
    T = num_scans * IMU_PER_SCAN
    rng = np.random.default_rng(seed)
    v, w = 0.3 / SCAN_PERIOD_S, 0.004 / SCAN_PERIOD_S
    acc = np.tile([0.0, v * w, 9.81], (T, 1)) + 0.03 * rng.normal(
        size=(T, 3))
    gyro = np.tile([0.0, 0.0, w], (T, 1)) + 0.002 * rng.normal(size=(T, 3))
    return acc, gyro, np.full(T, SCAN_PERIOD_S / IMU_PER_SCAN)


def fusion_phase(dev, scans, scan_mask, odo_out):
    """Phase 22: ndt_eskf_fusion over the odometry scans. Returns the
    kernels' launches in its run and the ESKF's ms a tick."""
    import torch

    from toyslam_tpu_torch.ops.launches import launches, reset_launches
    from toyslam_tpu_torch.estimators import eskf
    from toyslam_tpu_torch.pipelines import fusion

    S = scans.shape[0]
    acc, gyro, dt = imu_log(S)
    args = [torch.from_numpy(a).to(dev, torch.float32)
            for a in (acc, gyro, dt)]
    cfg = fusion.FusionConfig(imu_per_scan=IMU_PER_SCAN)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fusion.ndt_eskf_fusion(scans, scan_mask, *args, cfg)
    torch.cuda.synchronize()
    fus_s = time.perf_counter() - t0
    fus_launch = {k: v for k, v in launches().items()
                  if k in NEW_PATH_KERNELS}
    same = torch.equal(out.poses, odo_out.poses)
    T = acc.shape[0]
    ticks = (np.arange(S) + 1) * IMU_PER_SCAN - 1
    meas = np.zeros((T, 3))
    meas[ticks] = out.poses.double().numpy()[:, :3, 3]
    valid = np.zeros(T, bool)
    valid[ticks] = out.converged.numpy()
    log64 = eskf.ESKFLog(*(torch.from_numpy(a) for a in
                           (dt, acc, gyro, meas, valid)))
    _, ref = eskf.eskf_run(log64, None, cfg.eskf)
    d_p = float((out.fused_p.double().cpu() - ref["p"]).abs().max())
    log = eskf.ESKFLog(args[2], args[0], args[1],
                       torch.from_numpy(meas).to(dev, torch.float32),
                       torch.from_numpy(valid).to(dev))
    _, syncs = count_syncs(lambda: eskf.eskf_run(log, None, cfg.eskf))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eskf.eskf_run(log, None, cfg.eskf)
    torch.cuda.synchronize()
    tick_ms = 1e3 * (time.perf_counter() - t0) / T
    short = eskf.ESKFLog(*(x[:IMU_PER_SCAN] for x in log))
    _, busy, n_ops, _ = device_profile(
        lambda: eskf.eskf_run(short, None, cfg.eskf))
    last_err = float(np.linalg.norm(out.fused_p[-1].double().cpu().numpy()
                                    - meas[ticks[-1]]))
    print(f"phase 22 ndt_eskf_fusion over the {S} odometry scans, "
          f"{IMU_PER_SCAN} IMU ticks a scan ({T} ticks): {fus_s:.2f} s; "
          f"launches {fus_launch}; poses equal to phase 4's odometry: "
          f"{same}; fused track vs the f64 ESKF on the CPU max {d_p:.3g} m "
          f"(bound {FUSED_TOL_M} m); last fused position {last_err:.3g} m "
          f"from the last fix")
    print(f"  the ESKF alone on the card: {tick_ms:.4f} ms a tick (host "
          f"clock over {T} ticks); {n_ops / IMU_PER_SCAN:.1f} device "
          f"operations a tick ({busy / IMU_PER_SCAN:.4f} ms device busy; "
          f"torch.profiler over {IMU_PER_SCAN} ticks); synchronising calls "
          f"in eskf_run by line: {syncs}")
    check(bool(out.converged.all()), "a fusion align did not converge")
    check(fus_launch["ndt_gather_repack"] > 0
          and fus_launch["ndt_terms_packed"] > 0,
          "K2 or K3 was never launched in the fusion path")
    check(same, "fusion poses differ from phase 4's odometry")
    check(d_p <= FUSED_TOL_M, "the fused track on the card is far from the "
                              "f64 ESKF")
    check(not syncs, "eskf_run made a host sync")
    return fus_launch, tick_ms


def uwb_phase():
    """Phase 23: uwb_demo on the card at its defaults but a 30 s run (60 s
    by default; cut for the script's time)."""
    tmp = tempfile.TemporaryDirectory()
    rc, stdout, app_s = run_module("toyslam_tpu_torch.apps.uwb_demo",
                                   tmp.name, "--duration", 30)
    tri = float(re.search(r"trilateration: .*?ATE ([\d.]+) m",
                          stdout).group(1))
    fused = float(re.search(r"ESKF fused .*?ATE ([\d.]+) m",
                            stdout).group(1))
    lines = [ln for ln in stdout.splitlines() if "ATE" in ln]
    print(f"phase 23 uwb_demo over 30 s ({app_s:.1f} s with the "
          f"process start): exit {rc}")
    for ln in lines:
        print(f"  {ln}")
    check(rc == 0 and fused < tri, "uwb_demo failed its gate or the fused "
                                   "ATE is not below the trilateration's")
    tmp.cleanup()


def fleet_inputs(dev):
    """Phase 24's fleet-64: FLEET_LANES lanes of FLEET_SCANS scans of 16 x
    1024 rays and each lane's seeded IMU log. Lane b is seed b // 4 of
    FLEET_SEEDS scenes from start scan b % 4: the ray casting of 64 scenes
    costs ~0.9 s of host a lane, so 16 scenes serve 4 lanes each."""
    import torch

    from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans

    per_seed = FLEET_LANES // FLEET_SEEDS
    scans, masks = [], []
    for seed in range(FLEET_SEEDS):
        xyzi, mask, _ = spinning_lidar_scans(
            seed, FLEET_SCANS + per_seed - 1, *FLEET_RAYS)
        for start in range(per_seed):
            scans.append(xyzi[start:start + FLEET_SCANS])
            masks.append(mask[start:start + FLEET_SCANS])
    imu = [imu_log(FLEET_SCANS, seed=b) for b in range(FLEET_LANES)]
    acc, gyro, dt = (torch.from_numpy(np.stack([x[i] for x in imu])).to(
        dev, torch.float32) for i in range(3))
    return (torch.from_numpy(np.stack(scans)).to(dev),
            torch.from_numpy(np.stack(masks)).to(dev), acc, gyro, dt)


def lane_kernel_args(m, src, cfg, poses):
    """K1 and K3 lane operands over every lane of a lane map and its
    sources at host poses [B, 6] (a row a lane, in lane order), the
    neighbourhoods of K3 gathered at those poses; and each lane's counts
    for the bounds."""
    import torch

    from toyslam_tpu_torch.ops import ndt_kernels
    from toyslam_tpu_torch.registration import ndt

    B = src.mask.shape[0]
    d1, d2, _ = ndt.gauss_coefficients(cfg.resolution, cfg.outlier_ratio)
    offsets = ndt._OFFSETS[cfg.search_method]
    ev = ndt._LaneEvaluator(m, src.xyzi, src.mask, cfg.resolution, offsets,
                            d1, d2)
    params = ev.params(list(poses))
    xyz = ev.xyz
    hashed = [ndt_kernels.ndt_neighbor_hash_plain(
        params[b], xyz[b], src.mask[b], m.min_b[b], m.div[b], ev.cap,
        ev.inv_leaf, ev.offsets) for b in range(B)]
    stats = torch.stack([ndt_kernels.ndt_gather_repack_plain(
        m.hash_table[b], *hashed[b]) for b in range(B)])
    ids = torch.arange(B, dtype=torch.int32, device=xyz.device)
    k1 = (params, xyz, src.mask, m.hash_table, m.min_b, m.div, ev.inv_leaf,
          ev.offsets, ids)
    k3 = (params, xyz, stats, ids)
    counts = []
    for b in range(B):
        gate = stats[b, 9] > 0.5
        h, _, okm = hashed[b]
        counts.append({
            "valid": int(src.mask[b].sum()),
            "open_pairs": int(gate.sum()),
            "open_points": int(gate.view(len(offsets), -1).any(0).sum()),
            "rows": int(torch.unique(h[okm]).numel()),
            "open_rows": int(torch.unique(h[gate]).numel()),
            "pairs": int(gate.numel())})
    return k1, k3, counts


def lane_bounds(k1, k3, counts, L):
    """The bounds of a K1 and a K3 launch over lanes 0..L-1, as phase 6
    counts one lane, summed over the lanes."""
    params, xyz = k1[0], k1[1]
    n = xyz.shape[2]
    c = counts[:L]
    per_lane_in = 4 * 83 + 4 * 3 * n  # a params row and a lane's points
    k1_bytes = sum(per_lane_in + n + 2 * 3 * 4 + 16 * x["rows"]
                   + 32 * x["open_rows"] + 28 * 4 for x in c) + nbytes(k1[7])
    k1_ops = sum(NDT_FLOPS_TRANSFORM * x["valid"]
                 + (NDT_FLOPS_PER_POINT - NDT_FLOPS_TRANSFORM)
                 * x["open_points"] + NDT_FLOPS_PER_PAIR * x["open_pairs"]
                 for x in c)
    k3_bytes = sum(per_lane_in + 4 * x["pairs"] + 36 * x["open_pairs"]
                   + 28 * 4 for x in c)
    k3_ops = sum(NDT_FLOPS_PER_POINT * x["open_points"]
                 + NDT_FLOPS_PER_PAIR * x["open_pairs"] for x in c)
    return bound(k1_bytes, k1_ops), bound(k3_bytes, k3_ops)


def align_edge(xyzi, mask, k, warms, ends, ocfg):
    """Whether scan k's align of one fleet lane, which the kernel and plain
    routes end more than ``transformation_epsilon`` apart, sits on an edge
    of the data (the question ``diag/ndt_odometry_edge`` asks of
    odometry-256k's scan 10): the f64 align of the same scan pair through
    the plain versions from each route's warm start (``warms``) and, where
    those lie within ``transformation_epsilon`` of each other (no earlier
    align of the lane ended apart), from the first moved by EDGE_MOVE along
    every axis of the pose chart. Returns
    the largest distance between two of those f64 ends and, for each
    route's end (``ends``), its distance to the nearest f64 end; a
    distance is the larger of its m and rad."""
    from toyslam_tpu_torch.diag import ndt_odometry_edge
    from toyslam_tpu_torch.pipelines import odometry
    from toyslam_tpu_torch.registration import ndt

    x = xyzi.double()
    with ndt_odometry_edge.plain_route():
        prev = odometry._downsample(x[k - 1], mask[k - 1], ocfg)
        cur = odometry._downsample(x[k], mask[k], ocfg)
        m = ndt.build_ndt_map(prev, ocfg.ndt)
        starts = [w.double() for w in warms]
        if max(pose_diff(*starts)) <= ocfg.ndt.transformation_epsilon:
            starts += [ndt_odometry_edge._moved(starts[0], axis,
                                                sign * EDGE_MOVE)
                       for axis in range(6) for sign in (1.0, -1.0)]
        refs = [ndt.ndt_align(m, cur, g, ocfg.ndt).transform.numpy()
                for g in starts]

    def dist(a, b):
        return max(pose_diff(a, b))

    spread = max(dist(a, b) for a in refs for b in refs)
    return spread, [min(dist(e, r) for r in refs) for e in ends]


def torch_equal_bits(a, b):
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def fleet_phase(dev, single_tick_ms):
    """Phase 24: the fleet (BASELINE config 5) at fleet-64 through
    ``fleet_fusion`` (K2, K3) and ``vmap_align`` on the lanes' first pairs
    (K1). Returns {kernel: {key: value}} for the kernels line."""
    import torch

    from toyslam_tpu_torch.core import pointcloud
    from toyslam_tpu_torch.ops import ndt_kernels
    from toyslam_tpu_torch.ops.launches import launches, reset_launches
    from toyslam_tpu_torch.parallel import batch
    from toyslam_tpu_torch.pipelines import fusion, odometry
    from toyslam_tpu_torch.registration import ndt

    card = card_line()
    t0 = time.perf_counter()
    scans, masks, acc, gyro, dt = fleet_inputs(dev)
    gen_s = time.perf_counter() - t0
    B, S = masks.shape[:2]
    cfg = fusion.FusionConfig(
        odometry=odometry.OdometryConfig(work_capacity=FLEET_CAPACITY),
        imu_per_scan=IMU_PER_SCAN)
    chunk = fusion.FLEET_CHUNK
    print(f"phase 24 fleet-64: {B} lanes x {S} scans of {scans.shape[2]} "
          f"rays ({FLEET_SEEDS} scenes, {B // FLEET_SEEDS} start scans "
          f"each; {gen_s:.1f} s on the host), work_capacity "
          f"{FLEET_CAPACITY}, {IMU_PER_SCAN} IMU ticks a scan; chunk {chunk}")

    # The fleet's run, counts from 0.
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fusion.fleet_fusion(scans, masks, acc, gyro, dt, cfg, chunk)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    fleet_launch = {k: v for k, v in launches().items()
                    if k in ("ndt_terms_gathered", "ndt_gather_repack",
                             "ndt_terms_packed")}
    lane_rows = dict(ndt_kernels.LANE_ROWS)
    o = out.odometry
    steps = S - 1
    rounds = int(o.host_syncs[::chunk, 1:].sum())  # one a chunk, every scan
    print(f"  fleet_fusion: {fleet_s:.2f} s, {B * steps / fleet_s:.2f} "
          f"aggregate scans/s ({card}); launches {fleet_launch}, lane rows "
          f"{lane_rows}; {rounds / steps:.2f} lockstep rounds = host syncs a "
          f"scan step over the {B // chunk} chunks "
          f"({rounds / steps / (B // chunk):.2f} a chunk)")
    poses = o.poses.double().numpy()
    check(bool(out.converged.all()), "a fleet align did not converge")
    check(np.isfinite(poses).all() and bool(torch.isfinite(out.fused_p).all()),
          "non-finite fleet trajectory")
    check(fleet_launch["ndt_terms_packed"] > 0
          and fleet_launch["ndt_gather_repack"] > 0,
          "the fleet launched no K3 or no K2")
    its = o.iterations[:, 1:]
    mixed = int((its != its[:1]).any(0).sum())
    print(f"  iterations a lane: min {int(its.min())} max {int(its.max())}; "
          f"scans whose lanes' iterations differ: {mixed} of {steps}")
    check(mixed > 0, "every lane took the same iterations: the lockstep "
                     "masking is not exercised")
    # Every lockstep round evaluated each running lane once.
    ev = o.evaluations[:, 1:].reshape(B // chunk, chunk, steps)
    check(torch.equal(o.host_syncs[:, 1:].reshape(B // chunk, chunk,
                                                  steps)[:, 0], ev.amax(1)),
          "lockstep rounds differ from the lanes' most evaluations")

    # Lanes against ndt_odometry alone: one lane of every other scene of the
    # first chunk, its start scans in turn, and the last lane of every
    # other chunk.
    per = FLEET_LANES // FLEET_SEEDS
    lanes = sorted({min(per * 2 * s + s % per, chunk - 1)
                    for s in range(max(chunk // (2 * per), 1))}
                   | set(range(2 * chunk - 1, B, chunk)))
    t0 = time.perf_counter()
    fused_gap = 0.0
    for b in lanes:
        one = odometry.ndt_odometry(scans[b], masks[b], cfg.odometry)
        for name, g, w in zip(one._fields, o, one):
            if name != "host_syncs":
                check(torch.equal(g[b], w), f"fleet lane {b}'s {name} "
                                            "differs from ndt_odometry alone")
        alone = fusion._fused(one, acc[b], gyro[b], dt[b], cfg)
        fused_gap = max(fused_gap, float(
            (out.fused_p[b] - alone.fused_p).abs().max()))
    print(f"  {len(lanes)} lanes ({lanes}) equal to ndt_odometry alone bit "
          f"for bit (poses, "
          f"iterations, evaluations, gathers) ({time.perf_counter() - t0:.1f}"
          f" s); fused track vs the lane's own ESKF run max {fused_gap:.3g} m "
          f"(bound {FLEET_FUSED_TOL_M} m)")
    check(fused_gap <= FLEET_FUSED_TOL_M, "a fleet lane's fused track is far "
                                          "from its single-lane ESKF run")

    # One chunk through the plain versions, every kernel call checked.
    calls = []
    c = chunk
    with checked_plain_route(calls):
        plain = fusion.ndt_eskf_fusion_lanes(scans[:c], masks[:c], acc[:c],
                                             gyro[:c], dt[:c], cfg)
    by = {}
    for name, L, e, good, same in calls:
        mag = e[1] if isinstance(e, tuple) else e  # K2: its max abs error
        n, w, g, s, rows = by.get(name, (0, 0.0, True, True, 0))
        by[name] = (n + 1, max(w, mag), g and good,
                    s and same is not False, rows + L)
    pp = plain.poses.double().numpy()
    chain_t = float(np.abs(pp[..., :3, 3] - poses[:c, :, :3, 3]).max())
    chain_r = max(rotation_angle(a[:3, :3], b_[:3, :3])
                  for a, b_ in zip(pp.reshape(-1, 4, 4),
                                   poses[:c].reshape(-1, 4, 4)))
    # Each scan's align, pairwise: an align stops once its Newton step is
    # below transformation_epsilon, so two routes whose sums differ in
    # rounding can stop a step apart, and the chain adds those steps up.
    pw = [[pose_diff(a, b_) for a, b_ in zip(
        plain.odometry.pairwise[b].numpy(), o.pairwise[b].numpy())]
        for b in range(c)]
    gaps = np.array(pw)  # [c, S, 2]
    worst = np.unravel_index(np.argmax(gaps[..., 0]), gaps.shape[:2])
    d_t, d_r = float(gaps[..., 0].max()), float(gaps[..., 1].max())
    fleet_eps = cfg.odometry.ndt.transformation_epsilon
    # Aligns that end apart: each must be an edge of the data.
    t0 = time.perf_counter()
    eye = torch.eye(4, dtype=o.pairwise.dtype)
    edges = []
    for b, k in zip(*np.nonzero((gaps[:, 1:] > fleet_eps).any(-1))):
        k += 1  # scan 0 seeds each lane
        routes = (o.pairwise[b], plain.odometry.pairwise[b])
        warms = [r[k - 1] if cfg.odometry.warm_start else eye for r in routes]
        spread, reached = align_edge(scans[b], masks[b], int(k), warms,
                                     [r[k].double().numpy() for r in routes],
                                     cfg.odometry)
        edges.append((int(b), int(k), float(gaps[b, k].max()), spread,
                      max(reached)))
    edge_s = time.perf_counter() - t0
    k3 = by.get("ndt_terms_packed_lanes")
    check(k3 is not None, "the plain fleet route reached no K3 lane call")
    n, w, g, s, rows = k3
    print(f"  ndt_terms_packed lane launches along the plain route of lanes "
          f"0-{c - 1}: {n} launches, {rows} lane rows; max err {w:.3g} of "
          f"the terms' magnitudes (bound {TERMS_MAG_RTOL}), within: {g}; "
          f"every row bit-identical to its single-lane launch: {s}")
    check(g, "ndt_terms_packed's lane kernel disagrees with its plain "
             "version")
    check(s, "ndt_terms_packed's lane kernel differs from its single-lane "
             "launch")
    k2 = by.get("ndt_gather_repack", (0, 0.0, False, True, 0))
    print(f"  ndt_gather_repack along the same route: {k2[0]} launches over "
          f"the regathering lanes' pairs (up to {c} lanes' in a [{c} x "
          f"{cfg.odometry.ndt.grid_capacity}, 16] table), bit-identical to its plain version: "
          f"{k2[2]}")
    check(k2[0] and k2[2], "K2 disagrees with its plain version along the "
                           "fleet")
    check(set(by) == {"ndt_terms_packed_lanes", "ndt_gather_repack"},
          f"the plain fleet route reached {set(by)}")
    print(f"  kernels vs plain fleet of lanes 0-{c - 1}: each scan's align "
          f"(pairwise) max {d_t:.3g} m (lane {worst[0]}, scan {worst[1]}), "
          f"{d_r:.3g} rad (bound off an edge of the data: the align's "
          f"transformation_epsilon, {fleet_eps} m and rad); the chained "
          f"poses max {chain_t:.3g} m, {chain_r:.3g} rad")
    print(f"  aligns of the {c * (S - 1)} that end more than "
          f"{fleet_eps} apart: {len(edges)}; each against the f64 align "
          f"through the plain versions from both routes' warm starts and, "
          f"where those agree, the kernel route's moved by {EDGE_MOVE} "
          f"along each axis ({edge_s:.1f} s): "
          + "; ".join(f"lane {b} scan {k}: routes {g:.3g} apart, f64 ends "
                      f"spread {sp:.3g}, each route within {r:.3g} of an "
                      f"f64 end" for b, k, g, sp, r in edges))
    check(all(sp > fleet_eps and r <= fleet_eps
              for _, _, _, sp, r in edges),
          "the fleet's kernel and plain routes disagree off an edge of the "
          "data")

    # One lockstep align of a chunk: one host sync a round.
    ds = [pointcloud.voxel_downsample_lanes(
        scans[:chunk, k], masks[:chunk, k], cfg.odometry.scan_leaf,
        FLEET_CAPACITY, with_intensity=False) for k in (0, 1)]
    lmap = ndt.build_ndt_map_lanes(ds[0], cfg.odometry.ndt)
    count_syncs(lambda: None)  # the mode's own one-time warning
    res, where = count_syncs(lambda: ndt.ndt_align_lanes(
        lmap, ds[1], None, cfg.odometry.ndt))
    reported = sum(where.values())
    print(f"  one lockstep align of {chunk} lanes: {int(res.host_syncs[0])} "
          f"rounds, evaluations a lane {res.evaluations.tolist()}; "
          f"synchronising calls reported by the sync debug mode {reported}: "
          f"{where}")
    check(reported == int(res.host_syncs[0])
          == int(res.evaluations.max()), "not one host sync a lockstep round")

    # Device operations and busy share over one scan step of a chunk.
    state = odometry.odometry_init_lanes(scans[:chunk, 0], masks[:chunk, 0],
                                         cfg.odometry)
    step = {}
    wall, busy, n_ops, top = device_profile(lambda: step.update(
        out=odometry.odometry_step_lanes(state, scans[:chunk, 1],
                                         masks[:chunk, 1], cfg.odometry)))
    r = int(step["out"][1][7][0])
    print(f"  one scan step of a {chunk}-lane chunk under torch.profiler: "
          f"wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f} %), {n_ops} device operations, {r} "
          f"rounds ({n_ops / r:.1f} "
          f"operations a round, map build and downsample included); top:")
    for key, calls_, dev_ms in top:
        print(f"    {dev_ms:.3f} ms in {calls_} calls: {key[:90]}")

    # The batched ESKF over the fleet's lanes: the fixes' log and one pass.
    T = acc.shape[1]
    _, eskf_syncs = count_syncs(lambda: fusion._fused(o, acc, gyro, dt, cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fusion._fused(o, acc, gyro, dt, cfg)
    torch.cuda.synchronize()
    tick_ms = 1e3 * (time.perf_counter() - t0) / T
    print(f"  the ESKF over {B} lanes: {tick_ms:.4f} ms a tick for all lanes "
          f"(host clock over {T} ticks; phase 22's single lane "
          f"{single_tick_ms:.4f}); "
          f"synchronising calls in the fixes' log and eskf_run by line: "
          f"{eskf_syncs}")
    check(not eskf_syncs, "eskf_run over lanes made a host sync")

    # K1 and K3 lane launches at the fleet shape, L = 16 and 64: lanes'
    # scans 0 as maps, scans 1 as sources at the identity.
    m64 = ndt.build_ndt_map_lanes(pointcloud.voxel_downsample_lanes(
        scans[:, 0], masks[:, 0], cfg.odometry.scan_leaf, FLEET_CAPACITY,
        with_intensity=False), cfg.odometry.ndt)
    s64 = pointcloud.voxel_downsample_lanes(
        scans[:, 1], masks[:, 1], cfg.odometry.scan_leaf, FLEET_CAPACITY,
        with_intensity=False)
    k1, k3, counts = lane_kernel_args(m64, s64, cfg.odometry.ndt,
                                      np.zeros((B, 6), np.float32))
    lane_ms = {}
    for L in FLEET_LANE_WIDTHS:
        a1 = (k1[0][:L],) + k1[1:8] + (k1[8][:L],)
        a3 = (k3[0][:L],) + k3[1:3] + (k3[3][:L],)
        b1, b3 = lane_bounds(k1, k3, counts, L)
        for name, fn, args, bd in (
                ("ndt_terms_gathered", ndt_kernels.ndt_terms_gathered_lanes,
                 a1, b1),
                ("ndt_terms_packed", ndt_kernels.ndt_terms_packed_lanes, a3,
                 b3)):
            got = fn(*args)
            want = getattr(ndt_kernels, name + "_lanes_plain")(*args)
            rel = max(terms_err(got[y], want[y], NDT_GROUPS)[0]
                      for y in range(L))
            check(rel <= TERMS_RTOL, f"{name} lanes at L {L}: {rel:.3g}")
            d_ms = device_ms_per_launch(lambda f=fn, a=args: f(*a),
                                        CUDA_NAMES[name])
            lane_ms.setdefault(name, {})[L] = {
                "device_ms": d_ms, "bound_ms": bd[0], "bound_by": bd[1],
                "ms": cuda_ms(lambda f=fn, a=args: f(*a)),
                "max_rel_err": rel}
    print(f"  lane launches at the fleet shape (N {FLEET_CAPACITY}, DIRECT7, "
          f"identity poses; {card}), torch.profiler's device time a launch "
          f"over {REPS}:")
    for name, per in lane_ms.items():
        for L, x in per.items():
            print(f"    {name} L {L}: device {x['device_ms']:.4f} ms "
                  f"({x['device_ms'] / L:.5f} a lane), by events "
                  f"{x['ms']:.4f} ms, bound {x['bound_ms']:.4f} ms "
                  f"({x['bound_by']}; {x['bound_ms'] / x['device_ms']:.1%} "
                  f"reached); vs plain max rel err {x['max_rel_err']:.3g}")

    # vmap_align on the lanes' first pairs through K1.
    reset_launches()
    t0 = time.perf_counter()
    va = batch.vmap_align(scans[:, 0], masks[:, 0], scans[:, 1], masks[:, 1])
    va_s = time.perf_counter() - t0
    va_launch = launches()["ndt_terms_gathered"]
    for b in (0, B - 1):
        one = ndt.ndt_align(
            ndt.build_ndt_map(pointcloud.PointCloud(scans[b, 0], masks[b, 0]),
                              ndt.NDTConfig()),
            pointcloud.PointCloud(scans[b, 1], masks[b, 1]))
        check(torch.equal(va.pose6[b], one.pose6)
              and int(va.evaluations[b]) == one.evaluations,
              f"vmap_align lane {b} differs from ndt_align alone")
    print(f"  vmap_align over the {B} lanes' scans 0 and 1 (NDTConfig(): "
          f"exact, K1): {va_s:.2f} s, {va_launch} K1 launches = rounds "
          f"{int(va.host_syncs[0])}; iterations {va.iterations.min().item()}"
          f"-{va.iterations.max().item()}; lanes 0 and {B - 1} equal to "
          f"ndt_align alone bit for bit")
    check(bool(va.converged.all()) and va_launch == int(va.host_syncs[0]) > 0,
          "vmap_align did not converge or did not run one K1 launch a round")

    # The chunk sweep; chunk FLEET_CHUNK again is the rerun.
    sweep = {}
    for width in FLEET_CHUNKS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = fusion.fleet_fusion(scans, masks, acc, gyro, dt, cfg, width)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        same_odo = all(torch.equal(a, b_) for name, a, b_ in zip(
            o._fields, again.odometry, o) if name != "host_syncs")
        gap = float((again.fused_p - out.fused_p).abs().max())
        sweep[width] = {"s": sec, "scans_per_s": B * steps / sec,
                        "odometry_equal": same_odo, "fused_gap_m": gap}
        check(same_odo, f"chunk {width} changed a lane's odometry")
        check(gap <= FLEET_FUSED_TOL_M, f"chunk {width} moved a fused track "
                                        f"by {gap:.3g} m")
        if width == chunk:
            check(all(torch.equal(a, b_) for a, b_ in zip(
                again[1:4], out[1:4])), "the fleet's rerun is not "
                                        "bit-identical")
    print(f"  chunk sweep ({card}), host clock of one fleet_fusion over "
          f"B {B}: " + "; ".join(
              f"chunk {w}: {x['s']:.2f} s, {x['scans_per_s']:.2f} scans/s, "
              f"odometry equal {x['odometry_equal']}, fused max "
              f"{x['fused_gap_m']:.3g} m" for w, x in sweep.items())
          + f"; chunk {chunk} rerun bit-identical")
    return {
        "ndt_terms_gathered": {
            "fleet_launches": fleet_launch["ndt_terms_gathered"],
            "vmap_align_launches": va_launch,
            "fleet_lane_launches": lane_ms["ndt_terms_gathered"]},
        "ndt_gather_repack": {
            "fleet_launches": fleet_launch["ndt_gather_repack"]},
        "ndt_terms_packed": {
            "fleet_launches": fleet_launch["ndt_terms_packed"],
            "fleet_lane_rows": lane_rows["ndt_terms_packed"],
            "fleet_lane_launches": lane_ms["ndt_terms_packed"]}}


def loam_inputs(rays, seed, capacity=None):
    """64 scans of the LOAM test world's drive (f64 motion step, as the
    benchmark builds it) at ``rays`` = (rings, rays a ring): (xyzi [S, N,
    4] f32, mask, ground-truth poses [S, 4, 4])."""
    from toyslam_tpu_torch.sim import loam_world

    scans, poses = loam_world.drive(LOAM_SCANS, seed, n_rings=rays[0],
                                    n_per_ring=rays[1],
                                    step_dtype=np.float64)
    xyzi, mask = loam_world.pack(scans, capacity)
    return xyzi, mask, poses


def loam_config(rays):
    from toyslam_tpu_torch.pipelines import loam

    return loam.LoamConfig(n_rings=rays[0], vertical_fov_deg=LOAM_FOV)


def smoother_log():
    """bench.py's smoother log as numpy arrays (f32, as it builds it)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import jax_smoother_refs

    return jax_smoother_refs.bench_log()


def smoother_args(log, dtype, dev):
    import torch

    M = log["p"].shape[0]
    args = [torch.from_numpy(log[k]).to(dev, dtype)
            for k in ("acc", "gyro", "dt")]
    args += [torch.from_numpy(log["valid"]).to(dev),
             torch.from_numpy(log["t"]).to(dev, dtype),
             torch.from_numpy(log["p"]).to(dev, dtype),
             torch.ones(M, dtype=torch.bool, device=dev)]
    return args


def window_fixture_run(dtype, dev):
    """``tests/test_window.py::test_window_f32_matches_f64``'s loop on its
    own inputs (tests/fixtures): window 10, 5 Gauss-Newton steps, through
    the fusion app's keyframe loop. Returns (p, v [13, 3]) f64 numpy."""
    import torch

    from toyslam_tpu_torch.apps import fusion_demo
    from toyslam_tpu_torch.estimators import window

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import jax_smoother_refs

    z = np.load(jax_smoother_refs.FIXTURE)
    n, ipk = z["meas"].shape[0], z["acc"].shape[0] // z["meas"].shape[0]
    kf = np.arange(ipk - 1, n * ipk, ipk)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    q_start = np.concatenate([z["q0"][None], z["quat"][kf[:-1] + 1]], 0)
    est = fusion_demo.smooth(
        t(z["acc"].reshape(n, ipk, 3)), t(z["gyro"].reshape(n, ipk, 3)),
        t(np.full((n, ipk), 1.0 / 200.0)),
        torch.ones((n, ipk), dtype=torch.bool, device=dev), t(z["meas"]),
        t(np.arange(n, dtype=np.float64)), t(q_start), t(z["quat"][kf]),
        window.WindowConfig(window_size=10, gn_iterations=5, pos_sigma=0.05))
    return est.p.double().cpu().numpy(), est.v.double().cpu().numpy()


def host_references():
    """The f64 runs on the host that phases 25 and 26 hold the card's f32
    runs against: loam-bench through loam_odometry
    (and its f64 feature extraction scan by scan), smoother-w20 through
    batch_fusion, and the window test's inputs. Runs in a process of its
    own while the card works through the earlier phases (``HostJob``)."""
    import torch

    from toyslam_tpu_torch.core.pointcloud import PointCloud
    from toyslam_tpu_torch.pipelines import batch_fusion, loam

    torch.set_num_threads(HOST_REF_THREADS)
    out = {}
    for name, rays, seed, cap in LOAM_CELLS:
        xyzi, mask, _ = loam_inputs(rays, seed, cap)
        x = torch.from_numpy(xyzi).double()
        m = torch.from_numpy(mask)
        cfg = loam_config(rays)
        t0 = time.perf_counter()
        lo = loam.loam_odometry(x, m, cfg)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_p"] = lo.positions.numpy()
        out[f"{name}_q"] = lo.quaternions.numpy()
        out[f"{name}_kf"] = int(lo.n_keyframes)
    xyzi, mask, _ = loam_inputs(LOAM_BENCH, LOAM_BENCH_SEED)
    x = torch.from_numpy(xyzi).double()
    m = torch.from_numpy(mask)
    cfg = loam_config(LOAM_BENCH)
    for k in range(LOAM_SCANS):
        cloud = PointCloud(x[k], m[k])
        org = loam.organize_scan(cloud, cfg)
        f = loam.organize_and_extract(cloud, cfg)
        for name, val in (("xyz", org.xyz), ("curv", org.curvature),
                          ("cur_ok", org.cur_ok), ("edge_thr", org.edge_thr),
                          ("surf_thr", org.surf_thr),
                          ("edge", f.edge_xyz[f.edge_mask]),
                          ("surf", f.surf_xyz[f.surf_mask])):
            out[f"org{k}_{name}"] = val.numpy()
    t0 = time.perf_counter()
    bf = batch_fusion.batch_fusion(
        *smoother_args(smoother_log(), torch.float64, "cpu"),
        config=batch_fusion.BatchFusionConfig())
    out["smoother_s"] = time.perf_counter() - t0
    out["smoother_p"], out["smoother_v"] = bf.kf_p.numpy(), bf.kf_v.numpy()
    out["window_p"], out["window_v"] = window_fixture_run(torch.float64,
                                                          "cpu")
    return out


def golden_chains(inputs):
    """The f64 golden chains of phase 17 from the clouds in ``inputs``
    (g0.. the golden sequence's, o0.. odometry-256k's; ``ndt`` the NDT
    configuration's resolution, step, epsilon and iteration cap)."""
    res, step, eps, iters = inputs["ndt"]
    ncfg = SimpleNamespace(resolution=float(res), step_size=float(step),
                           transformation_epsilon=float(eps),
                           max_iterations=int(iters))
    out = {}
    for key in ("g", "o"):
        clouds = [inputs[f"{key}{k}"] for k in range(sum(
            1 for name in inputs if name[0] == key and name[1:].isdigit()))]
        t0 = time.perf_counter()
        out[key] = golden_chain(clouds, ncfg)
        out[f"{key}_s"] = time.perf_counter() - t0
    return out


def gnss_bench_log(dev):
    """bench.py:461-527's GNSS log with the port's f64 functions on ``dev``
    from the same numpy draws: (store, iono, the run_epochs channels, ref
    ECEF [3], truth [E, 3])."""
    import math

    import torch

    from toyslam_tpu_torch.core.geodesy import (SPEED_OF_LIGHT,
                                                ecef_to_enu_rotation,
                                                lla_to_ecef)
    from toyslam_tpu_torch.gnss import atmosphere, pipeline, spp
    from toyslam_tpu_torch.gnss.ephemeris import (GpsEphemeris,
                                                  sat_pos_vel_clock)
    from toyslam_tpu_torch.gnss.local import W_C

    E, S = GNSS_EPOCHS, GNSS_SATS
    f64 = torch.float64
    rng = np.random.default_rng(GNSS_SEED)

    def t(v):
        return torch.as_tensor(v, dtype=f64, device=dev)

    lat0, lon0 = t(math.radians(22.3)), t(math.radians(114.17))
    ref = lla_to_ecef(lat0, lon0, t(50.0))
    R = ecef_to_enu_rotation(lat0, lon0)
    v_ecef = spp.mat_vec(R.T, t([1.5, 0.4, 0.0]))
    eph = pipeline.synthetic_constellation(S, toe=1000.0, device=dev)
    store = pipeline.store_init(device=dev)
    for k in range(S):
        store = store.update(GpsEphemeris(*(x[k] for x in eph)))
    iono = atmosphere.IonoParams(alpha=t([0.0] * 4), beta=t([0.0] * 4))
    steps = torch.arange(E, dtype=f64, device=dev)
    tows = 1000.0 + steps
    pos = ref + v_ecef * steps[:, None]
    sat = sat_pos_vel_clock(eph, tows[:, None].expand(E, S))
    r0 = torch.linalg.norm(sat["pos"] - pos[:, None], dim=-1)
    for _ in range(2):
        sat = sat_pos_vel_clock(eph, tows[:, None] - r0 / SPEED_OF_LIGHT)
        r0 = torch.linalg.norm(sat["pos"] - pos[:, None], dim=-1)
    el = torch.asin((spp.mat_vec(R, sat["pos"] - pos[:, None])[..., 2]
                     / r0).clamp(-1, 1))
    sp, vel = sat["pos"], sat["vel"]
    sagnac = -W_C * (pos[:, None, 0] * sp[..., 1]
                     - pos[:, None, 1] * sp[..., 0])
    pr = (r0 + 42.0 + sagnac - sat["clock_bias"] * SPEED_OF_LIGHT
          - eph.tgd * SPEED_OF_LIGHT
          + 2.3 / torch.sin(el.abs()).clamp(min=0.1)
          + t(rng.normal(0, 1.5, (E, S))))
    los = (sp - pos[:, None]) / r0[..., None]
    sag_rate = W_C * (vel[..., 0] * pos[:, None, 1]
                      - vel[..., 1] * pos[:, None, 0])
    rr = ((los * (v_ecef - vel)).sum(-1) - sag_rate
          + sat["clock_drift"] * SPEED_OF_LIGHT
          + t(rng.normal(0, 0.05, (E, S))))
    prn = torch.arange(1, S + 1, dtype=torch.int32, device=dev).expand(E, S)
    channels = (tows, prn, pr, rr, torch.full((E, S), 45.0, dtype=f64,
                                              device=dev), el > 0)
    return store, iono, channels, ref, pos


def gnss_host_reference():
    """gnss-1024 through the port's f64 run_epochs and its f64 local solve
    (prep_epochs and solve_epochs_local in f64) on the host, phase 27's
    references (a process of its own, ``HostJob``)."""
    import torch

    from toyslam_tpu_torch.gnss import local, pipeline

    torch.set_num_threads(HOST_REF_THREADS)
    store, iono, channels, ref, _ = gnss_bench_log("cpu")
    cfg = pipeline.EpochConfig(apply_iono_correction=False)
    t0 = time.perf_counter()
    sols = pipeline.run_epochs(store, iono, *channels, ref, config=cfg)
    sec = time.perf_counter() - t0
    p, v = sols.position, sols.velocity
    ep = local.prep_epochs(store, iono, *channels, ref, config=cfg,
                           out_dtype=torch.float64)
    loc = local.solve_epochs_local(ep, cfg)
    return {"state": p.state.numpy(), "pdop": p.pdop.numpy(),
            "hdop": p.hdop.numpy(), "num_sats": p.num_sats.numpy(),
            "valid": p.valid.numpy(), "vel": v.vel_ecef.numpy(),
            "vel_valid": v.valid.numpy(), "used": sols.record.used.numpy(),
            "sec": np.float64(sec),
            "local_state": torch.cat([ref + loc.delta,
                                      loc.clock_bias[:, None]], -1).numpy(),
            "local_vel": loc.vel_ecef.numpy(), "local_pdop": loc.pdop.numpy(),
            "local_hdop": loc.hdop.numpy(),
            "local_num_sats": loc.num_sats.numpy()}


def race_pcd(path, rng):
    """A small binary PCD whose header lists x, y, z, intensity and up to
    28 extra fields in a random order (the packer's workers parse a
    different layout each)."""
    extra = [f"extra_{i}" for i in range(int(rng.integers(0, 29)))]
    names = list(rng.permutation(["x", "y", "z", "intensity"] + extra))
    nf, n = len(names), int(rng.integers(1, 4))
    header = (f"# .PCD v0.7\nVERSION 0.7\nFIELDS {' '.join(names)}\n"
              f"SIZE {' '.join(['4'] * nf)}\nTYPE {' '.join(['F'] * nf)}\n"
              f"COUNT {' '.join(['1'] * nf)}\nWIDTH {n}\nHEIGHT 1\n"
              f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n")
    path.write_bytes(header.encode()
                     + rng.normal(0, 5, (n, nf)).astype(np.float32).tobytes())


def bag_files(inputs):
    """Phase 28's files in ``inputs["dir"]``, written on the host (a
    process of its own while the card runs phases 1-27): bag-256k.bag and
    its scans as pcd/cloud_K.pcd, app.bag (the first APP_SCANS scans, lz4),
    small_bz2.bag (two cut scans, bz2), and race/ (RACE_SMALL small PCDs
    of random header layouts)."""
    from toyslam_tpu_torch.core import pcd_io
    from toyslam_tpu_torch.runtime import rosbag

    d = Path(str(inputs["dir"]))
    xyzi, mask = inputs["xyzi"], inputs["mask"]
    clouds = [xyzi[k][mask[k]] for k in range(len(xyzi))]
    stamped = [(BAG_T0 + 0.1 * k, c) for k, c in enumerate(clouds)]
    (d / "pcd").mkdir()
    for k, c in enumerate(clouds):
        pcd_io.write_pcd(d / "pcd" / f"cloud_{k}.pcd", c)
    t0 = time.perf_counter()
    rosbag.write_bag(d / "bag-256k.bag", stamped, topic=BAG_TOPIC,
                     compression="lz4")
    write_s = time.perf_counter() - t0
    rosbag.write_bag(d / "app.bag", stamped[:APP_SCANS], topic=BAG_TOPIC,
                     compression="lz4")
    rosbag.write_bag(d / "small_bz2.bag", [(BAG_T0, clouds[0][:5000]),
                                           (BAG_T0 + 0.1, clouds[1][:3000])],
                     topic=BAG_TOPIC, compression="bz2")
    (d / "race").mkdir()
    rng = np.random.default_rng(4)
    for k in range(RACE_SMALL):
        race_pcd(d / "race" / f"small_{k}.pcd", rng)
    return {"write_s": np.float64(write_s)}


HOST_JOBS = {"references": lambda inputs: host_references(),
             "golden": golden_chains,
             "gnss": lambda inputs: gnss_host_reference(),
             "bag": bag_files}
JOBS = []  # started host jobs, stopped at exit


class HostJob:
    """A host computation of ``HOST_JOBS`` in a process of its own
    (``chip_smoke.py --host-job KIND IN OUT``), started now and read with
    ``get()``."""

    def __init__(self, kind, inputs=None):
        self.dir = tempfile.TemporaryDirectory()
        d = Path(self.dir.name)
        np.savez(d / "in.npz", **(inputs or {}))
        self.path = d / "out.npz"
        self.log = open(d / "log", "w")
        self.kind = kind
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--host-job",
             kind, str(d / "in.npz"), str(self.path)],
            stdout=self.log, stderr=subprocess.STDOUT,
            cwd=Path(__file__).resolve().parent)
        self.data = None
        JOBS.append(self)

    def get(self):
        if self.data is None:
            rc = self.proc.wait(timeout=APP_TIMEOUT_S)
            self.log.close()
            check(rc == 0, f"the host job {self.kind} failed: "
                  + (Path(self.dir.name) / "log").read_text()[-2000:])
            self.data = dict(np.load(self.path))
            self.waited_s = time.perf_counter() - self.t0
        return self.data

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self.log.closed:
            self.log.close()
        self.dir.cleanup()


def host_job(kind, in_path, out_path):
    np.savez(out_path, **HOST_JOBS[kind](dict(np.load(in_path))))


def loam_keyframes(p, q, cfg):
    """The keyframe choice of loam_odometry replayed on its output poses
    (p [S, 3], wxyz q [S, 4], f64 numpy): (is_kf [S] bool, distance and
    angle from the last keyframe [S])."""
    import torch

    from toyslam_tpu_torch.core import se3

    rot = se3.quat_to_rot(torch.from_numpy(np.ascontiguousarray(q))).numpy()
    S = p.shape[0]
    is_kf = np.zeros(S, bool)
    dist, ang = np.zeros(S), np.zeros(S)
    last = 0
    for k in range(1, S):
        dist[k] = np.linalg.norm(p[k] - p[last])
        ang[k] = rotation_angle(rot[k], rot[last])
        is_kf[k] = (dist[k] > cfg.keyframe_dist or ang[k] > cfg.keyframe_angle
                    or k % cfg.keyframe_interval == 0)
        if is_kf[k]:
            last = k
    return is_kf, dist, ang


def loam_pick_edges(k, card, host, cfg):
    """The feature picks of scan k on the card (f32) against the host's
    (f64). A pick on one side only must be an edge of the data: the
    stencil sums of its window round differently in f32, so where two
    candidates of a (ring, sector) lie within the f32 error of the
    curvature measured on this scan (``err``), or a candidate lies within
    it (plus the thresholds' own f32 error) of its gate, or on a sector
    border, the two sides may choose differently. Returns (picks that
    differ, those not shown to be edges)."""
    key = {}
    for i, p in enumerate(host["xyz"]):
        key[tuple(p)] = i
    c64, c32 = host["curv"], np.full(len(host["curv"]), np.nan)
    ok = host["cur_ok"]
    for p, c, o in zip(card["xyz"], card["curv"], card["cur_ok"]):
        i = key.get(tuple(p))
        if i is not None and o and ok[i]:
            c32[i] = c
    both = ~np.isnan(c32)
    err = float(np.max(np.abs(c32[both] - c64[both]))) if both.any() else 0.0
    err_thr = max(float(np.max(np.abs(card["edge_thr"] - host["edge_thr"]))),
                  float(np.max(np.abs(card["surf_thr"] - host["surf_thr"]))))
    xyz = host["xyz"]
    az = (np.arctan2(xyz[:, 1], xyz[:, 0]) + np.pi) / (2 * np.pi) * (
        cfg.n_sectors)
    sector = np.clip(az.astype(np.int64), 0, cfg.n_sectors - 1)
    ring_f = (np.rad2deg(np.arctan2(xyz[:, 2], np.hypot(xyz[:, 0],
                                                         xyz[:, 1])))
              - LOAM_FOV[0]) / (LOAM_FOV[1] - LOAM_FOV[0]) * (cfg.n_rings - 1)
    ring = np.clip(np.round(ring_f), 0, cfg.n_rings - 1).astype(np.int64)
    seg = ring * cfg.n_sectors + sector
    differ, unshown = 0, 0
    for side, sign, thr, quota in (("edge", 1.0, host["edge_thr"],
                                    cfg.edge_per_sector),
                                   ("surf", -1.0, host["surf_thr"],
                                    cfg.surf_per_sector)):
        a = {tuple(p) for p in card[side]}
        b = {tuple(p) for p in host[side]}
        score = sign * c64
        gate = ok & (c64 > thr if side == "edge" else c64 < thr)
        for p in a ^ b:
            differ += 1
            i = key.get(p)
            if i is None:
                unshown += 1
                continue
            # The f64 ranking of its (ring, sector): a pick of the f64 run
            # against the best it left, any other point against the
            # weakest it took.
            ranked = np.sort(score[gate & (seg == seg[i])])[::-1]
            q = min(quota, len(ranked))
            other = (ranked[q] if len(ranked) > q else None) if p in b else (
                ranked[q - 1] if q else None)
            near_cut = other is not None and abs(score[i] - other) <= 2 * err
            near_gate = abs(c64[i] - thr[i]) <= err + err_thr
            near_border = (abs(az[i] - np.round(az[i])) < 1e-5
                           or abs(ring_f[i] % 1.0 - 0.5) < 1e-5)
            if not (near_cut or near_gate or near_border):
                unshown += 1
    return differ, unshown


def loam_phase(dev, refs):
    """Phase 25: loam_odometry over loam-hdl32 and loam-bench on the card
    (f32) against the host's f64 runs, the feature picks of loam-bench
    against the host's, and loam_demo at its defaults."""
    import torch

    from toyslam_tpu_torch.core.pointcloud import PointCloud
    from toyslam_tpu_torch.ops import eigh3_kernels
    from toyslam_tpu_torch.pipelines import loam

    card = card_line()
    ref = None
    summary = {}
    for name, rays, seed, cap in LOAM_CELLS:
        t0 = time.perf_counter()
        xyzi, mask, poses = loam_inputs(rays, seed, cap)
        gen_s = time.perf_counter() - t0
        x = torch.from_numpy(xyzi).to(dev)
        m = torch.from_numpy(mask).to(dev)
        cfg = loam_config(rays)
        eigh3_kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loam.loam_odometry(x, m, cfg)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        e3 = eigh3_kernels.LAUNCHES["eigh3"]
        r = LOAM_RERUN_SCANS
        again, syncs = count_syncs(lambda: loam.loam_odometry(x[:r], m[:r],
                                                              cfg))
        same = all(torch.equal(a[:r], b) for a, b in zip(out[:2], again[:2]))
        _, _, ops1, _ = device_profile(lambda: loam.loam_odometry(
            x[:1], m[:1], cfg))
        _, busy, opsk, top = device_profile(lambda: loam.loam_odometry(
            x[:LOAM_PROFILE_SCANS + 1], m[:LOAM_PROFILE_SCANS + 1], cfg))
        per_scan = (opsk - ops1) / LOAM_PROFILE_SCANS
        print(f"phase 25 {name}: {LOAM_SCANS} scans of {rays[0]} x {rays[1]}"
              f" rays ({int(mask.sum(1).min())}-{int(mask.sum(1).max())} "
              f"points, capacity {mask.shape[1]}; {gen_s:.1f} s to ray-cast "
              f"on the host), f32 on the card: {sec:.2f} s, "
              f"{(LOAM_SCANS - 1) / sec:.2f} scans/s ((S-1)/sec; {card}), "
              f"{int(out.n_keyframes)} keyframes, {e3} eigh3 launches; "
              f"rerun over the first {r} "
              f"scans bit-identical: {same}; synchronising calls by line "
              f"there: {syncs}")
        print(f"  {per_scan:.1f} device operations a scan "
              f"({busy / LOAM_PROFILE_SCANS:.3f} ms device busy a scan over "
              f"scans 1-{LOAM_PROFILE_SCANS}, with scan 0's set-up); top "
              f"device operations: "
              + "; ".join(f"{k[:60]} x{c} {t:.3f} ms" for k, c, t in top))
        check(bool(torch.isfinite(out.positions).all()
                   and torch.isfinite(out.quaternions).all()),
              f"{name}: a pose is not finite")
        check(int(out.n_keyframes) >= 1, f"{name}: no keyframe")
        check(e3 == LOAM_EIGH3_A_SCAN * (LOAM_SCANS - 1),
              f"{name}: eigh3 launched {e3} times, not "
              f"{LOAM_EIGH3_A_SCAN} a loam_step")
        check(same, f"{name}: a rerun differs")
        check(not syncs, f"{name}: loam_odometry synchronised with the host")

        # Against the host's f64 run, over the scans it tracks.
        if ref is None:
            ref = refs.get()
            print(f"  host references (f64, {HOST_REF_THREADS} threads, "
                  f"started {refs.waited_s:.1f} s ago): loam-hdl32 "
                  f"{float(ref['loam-hdl32_s']):.1f} s, loam-bench "
                  f"{float(ref['loam-bench_s']):.1f} s, smoother-w20 "
                  f"{float(ref['smoother_s']):.1f} s")
        gt = poses[:, :3, 3]
        p32 = out.positions.double().cpu().numpy()
        p64, q64 = ref[f"{name}_p"], ref[f"{name}_q"]
        e32 = np.linalg.norm(p32 - gt, axis=1)
        e64 = np.linalg.norm(p64 - gt, axis=1)
        lost = np.flatnonzero(e64 > LOAM_ATE_M)
        n = int(lost[0]) if len(lost) else LOAM_SCANS
        ate = float(np.sqrt(np.mean(e32[:n] ** 2)))
        dpos = np.linalg.norm(p32 - p64, axis=1)
        kf32, d32, a32 = loam_keyframes(
            p32, out.quaternions.double().cpu().numpy(), cfg)
        kf64, d64, a64 = loam_keyframes(p64, q64, cfg)
        split = np.flatnonzero(kf32 != kf64)
        first = int(split[0]) if len(split) else LOAM_SCANS
        # Once the keyframe choices split, the two runs merge into other
        # maps: the positions are compared before that, and a split is an
        # edge of the data only within LOAM_SPLIT_SCANS of the f64 run
        # losing track.
        n_cmp = min(first, n)
        print(f"  the host's f64 run tracks scans 0-{n - 1} within "
              f"{LOAM_ATE_M} m (whole-run ATE: f64 "
              f"{float(np.sqrt(np.mean(e64 ** 2))):.3f} m, card "
              f"{float(np.sqrt(np.mean(e32 ** 2))):.3f} m; "
              f"{int(ref[f'{name}_kf'])} and {int(out.n_keyframes)} "
              f"keyframes); over them the card's ATE {ate:.4f} m (bound "
              f"{LOAM_ATE_M}); card f32 vs host f64 positions over scans "
              f"0-{n_cmp - 1}, before the keyframe choices split: max "
              f"{dpos[:n_cmp].max():.3g} m at scan "
              f"{int(dpos[:n_cmp].argmax())}, median "
              f"{np.median(dpos[:n_cmp]):.3g} m (bound {LOAM_F64_TOL_M})")
        if first < LOAM_SCANS:
            k = first
            print(f"  first split at scan {k}: distance / angle from the last "
                  f"keyframe f32 {d32[k]:.4f} / {a32[k]:.4f}, f64 "
                  f"{d64[k]:.4f} / {a64[k]:.4f} (thresholds "
                  f"{cfg.keyframe_dist} / {cfg.keyframe_angle}); positions "
                  f"{dpos[k]:.3g} m apart; the f64 run's error there and "
                  f"after: {np.round(e64[k:k + LOAM_SPLIT_SCANS + 1], 3)}")
        print(f"  per scan, card f32 vs host f64 (m): "
              + " ".join(f"{v:.2g}" for v in dpos[:n]))
        check(n_cmp >= LOAM_MIN_TRACKED, f"{name}: compared over only {n_cmp}"
                                         f" scans")
        check(ate < LOAM_ATE_M, f"{name}: ATE {ate} m over the tracked scans")
        check(dpos[:n_cmp].max() <= LOAM_F64_TOL_M,
              f"{name}: the card is far from the host's f64 run")
        check(first >= n or n - first <= LOAM_SPLIT_SCANS,
              f"{name}: the keyframe choices split at scan {first}, "
              f"{n - first} scans before the f64 run loses track")
        summary[name] = {"scans_per_s": (LOAM_SCANS - 1) / sec,
                         "device_ops_per_scan": per_scan,
                         "eigh3_launches": e3}
        if name == "loam-bench":
            bench = (x, m, cfg)

    # loam-bench's feature picks against the host's, scan by scan (they do
    # not depend on the pose).
    x, m, cfg = bench
    differ_scans, differ_total, unshown_total = 0, 0, 0
    for k in range(LOAM_SCANS):
        cloud = PointCloud(x[k], m[k])
        org = loam.organize_scan(cloud, cfg)
        f = loam.organize_and_extract(cloud, cfg)
        card_k = {"xyz": org.xyz.double().cpu().numpy(),
                  "curv": org.curvature.double().cpu().numpy(),
                  "cur_ok": org.cur_ok.cpu().numpy(),
                  "edge_thr": org.edge_thr.double().cpu().numpy(),
                  "surf_thr": org.surf_thr.double().cpu().numpy(),
                  "edge": f.edge_xyz[f.edge_mask].double().cpu().numpy(),
                  "surf": f.surf_xyz[f.surf_mask].double().cpu().numpy()}
        host_k = {key: ref[f"org{k}_{key}"] for key in card_k}
        differ, unshown = loam_pick_edges(k, card_k, host_k, cfg)
        differ_scans += differ > 0
        differ_total += differ
        unshown_total += unshown
    print(f"  loam-bench feature picks, card f32 vs host f64: differ in "
          f"{differ_scans} of {LOAM_SCANS} scans ({differ_total} picks), "
          f"{unshown_total} not within the f32 error of a tie, a gate or a "
          f"sector or ring border")
    check(unshown_total == 0, "a feature pick differs from the f64 run "
                              "away from an edge of the data")

    tmp = tempfile.TemporaryDirectory()
    rc, stdout, app_s = run_module("toyslam_tpu_torch.apps.loam_demo",
                                   tmp.name)
    tmp.cleanup()
    ate_app = float(re.search(r"ATE vs synthetic ground truth: ([\d.]+) m",
                              stdout).group(1))
    print(f"  loam_demo at its defaults ({app_s:.1f} s with the process "
          f"start): exit {rc}; "
          + " | ".join(ln for ln in stdout.splitlines()[:2]))
    check(rc == 0 and ate_app < LOAM_ATE_M, "loam_demo failed")
    return summary


def smoother_phase(dev, refs):
    """Phase 26: batch_fusion over smoother-w20 on the card (f32): its
    rate, host syncs, a resume from a checkpoint, its drift from the
    host's f64 run; the window test's inputs against JAX's bounds; and
    fusion_demo at its defaults."""
    import torch

    from toyslam_tpu_torch.estimators import factors
    from toyslam_tpu_torch.pipelines import batch_fusion
    from toyslam_tpu_torch.utils import checkpoint

    card = card_line()
    log = smoother_log()
    M = log["p"].shape[0]
    args = smoother_args(log, torch.float32, dev)
    cfg = batch_fusion.BatchFusionConfig()
    K = cfg.window.window_size
    n = SMOOTHER_RESUME_AT
    # The run, timed with the sync debug mode on (it costs at a sync only),
    # in two calls: up to keyframe n, then on from that window in memory
    # (tests/test_torch_smoother.py holds such a split bit-identical to one
    # call). Then a resume from that window through a checkpoint file.
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def run():
        first = batch_fusion.batch_fusion(*(a[:n] for a in args), config=cfg)
        last = factors.NavState(first.kf_p[-1], first.kf_q[-1],
                                first.kf_v[-1], first.kf_ba[-1],
                                first.kf_bg[-1])
        rest = batch_fusion.batch_fusion(
            *(a[n:] for a in args), config=cfg, init_window=first.win,
            init_state=last, initialized=True)
        return first, last, rest

    (first, last, rest), syncs = count_syncs(run)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out = batch_fusion.BatchFusionOutput(
        *(torch.cat([a, b]) for a, b in zip(first[:6], rest[:6])), rest.win)
    tmp = tempfile.TemporaryDirectory()
    path = Path(tmp.name) / "window.npz"
    checkpoint.save_checkpoint(path, first.win)
    restored = checkpoint.load_checkpoint(path, first.win)
    tmp.cleanup()
    resumed = batch_fusion.batch_fusion(
        *(a[n:] for a in args), config=cfg, init_window=restored,
        init_state=last, initialized=True)
    resume_same = all(torch.equal(getattr(resumed, f), getattr(rest, f))
                      for f in ("kf_p", "kf_q", "kf_v", "kf_ba", "kf_bg",
                                "reset"))
    prof_args = [a[n:n + SMOOTHER_PROFILE_KF] for a in args]
    _, busy, ops, top = device_profile(lambda: batch_fusion.batch_fusion(
        *prof_args, config=cfg, init_window=restored, init_state=last,
        initialized=True))
    n_marg = M - K
    eigh_syncs = sum(v for k, v in syncs.items() if "estimators/window" in k)
    other_syncs = {k: v for k, v in syncs.items()
                   if "estimators/window" not in k}
    print(f"phase 26 smoother-w20: {M} keyframes of {log['acc'].shape[1]} "
          f"IMU samples, window {K}, f32 on the card: {sec:.2f} s, "
          f"{M / sec:.2f} keyframes/s ({card}); resume at keyframe {n} "
          f"through utils/checkpoint bit-identical to the run: "
          f"{resume_same}; synchronising calls by line: {syncs} ({n_marg} "
          f"marginalisations)")
    print(f"  {ops / SMOOTHER_PROFILE_KF:.1f} device operations a keyframe "
          f"({busy / SMOOTHER_PROFILE_KF:.3f} ms device busy a keyframe over "
          f"{SMOOTHER_PROFILE_KF} keyframes of a full window); top device "
          f"operations: "
          + "; ".join(f"{k[:60]} x{c} {t:.3f} ms" for k, c, t in top))
    check(all(bool(torch.isfinite(t).all()) for t in out[:5]),
          "smoother-w20: an output is not finite")
    check(resume_same, "smoother-w20: the resume differs from the run")
    # eigh's, one a marginalisation, and the second call's one read of the
    # window's count
    check(eigh_syncs == n_marg and sum(other_syncs.values()) == 1
          and all("pipelines/batch_fusion" in k for k in other_syncs),
          "smoother-w20: host syncs other than eigh's (one a "
          "marginalisation) and a resume's read of the window's count")

    ref = refs.get()
    p32 = out.kf_p.double().cpu().numpy()
    dp = np.linalg.norm(p32 - ref["smoother_p"], axis=1)
    dv = np.linalg.norm(out.kf_v.double().cpu().numpy() - ref["smoother_v"],
                        axis=1)

    def rms(a):
        return float(np.sqrt(np.mean(np.sum((a - log["p"]) ** 2, 1))))

    print(f"  card f32 vs host f64: position max {dp.max():.4f} m, velocity "
          f"median {np.median(dv):.4f} m/s (the JAX package's own f32 vs "
          f"f64 on this log: {JAX_DRIFT_POS_M:.4f} m, {JAX_DRIFT_VEL:.4f} "
          f"m/s; bounds twice those); RMS from the fixes f32 {rms(p32):.4f}"
          f" m, f64 {rms(ref['smoother_p']):.4f} m")
    check(dp.max() <= 2 * JAX_DRIFT_POS_M
          and np.median(dv) <= 2 * JAX_DRIFT_VEL,
          "smoother-w20: the card's f32 drifts from f64 more than twice as "
          "far as the JAX package's")
    wp, wv = window_fixture_run(torch.float32, dev)
    wdp = np.linalg.norm(wp - ref["window_p"], axis=1)
    wdv = np.linalg.norm(wv - ref["window_v"], axis=1)
    print(f"  tests/test_window.py's f32-vs-f64 inputs (window 10): card f32"
          f" vs host f64 position max {wdp.max():.3g} m (bound "
          f"{WINDOW_F32_POS_M}), velocity median {np.median(wdv):.3g} "
          f"(bound {WINDOW_F32_VEL_MEDIAN}), after keyframe 6 max "
          f"{wdv[6:].max():.3g} (bound {WINDOW_F32_VEL_LATE})")
    check(wdp.max() < WINDOW_F32_POS_M
          and np.median(wdv) < WINDOW_F32_VEL_MEDIAN
          and wdv[6:].max() < WINDOW_F32_VEL_LATE,
          "the window test's inputs: f32 on the card is outside the JAX "
          "test's bounds")

    tmp = tempfile.TemporaryDirectory()
    rc, stdout, app_s = run_module("toyslam_tpu_torch.apps.fusion_demo",
                                   tmp.name, "--duration",
                                   str(FUSION_DEMO_S))
    tmp.cleanup()
    print(f"  fusion_demo --duration {FUSION_DEMO_S} ({app_s:.1f} s with "
          f"the process start): exit {rc}")
    for ln in stdout.splitlines()[:4]:
        print(f"    {ln}")
    check(rc == 0, "fusion_demo failed its gate (smoothed RMSE below the "
                   "raw fixes')")
    return {"keyframes_per_s": M / sec,
            "device_ops_per_keyframe": ops / SMOOTHER_PROFILE_KF,
            "eigh_syncs": eigh_syncs}


def gnss_phase(dev, ref_job):
    """Phase 27: gnss-1024 through prep_epochs (f64) and solve_epochs_local
    (f32) on the card, held to the host's f64 run_epochs; run_epochs in f64
    on the card; the three GNSS apps at their defaults."""
    import torch

    from toyslam_tpu_torch.gnss import local, pipeline

    card = card_line()
    E = GNSS_EPOCHS
    cfg = pipeline.EpochConfig(apply_iono_correction=False)
    store, iono, channels, ref, truth = gnss_bench_log(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep = local.prep_epochs(store, iono, *channels, ref, config=cfg)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    # The solve under the sync debug mode, then a timed rerun
    sol, syncs = count_syncs(lambda: local.solve_epochs_local(ep, cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = local.solve_epochs_local(ep, cfg)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(sol, again))
    n = GNSS_PROFILE_EPOCHS
    part = local.LocalEpochs(*(x[:n] for x in ep[:-1]), ep.R_enu)
    _, busy, ops, top = device_profile(
        lambda: local.solve_epochs_local(part, cfg))
    print(f"phase 27 gnss-{E}: {E} epochs x {GNSS_SATS} satellites, f64 "
          f"prep on the card {prep_s:.3f} s, f32 solve {sec:.3f} s: "
          f"{E / sec:.1f} epochs/s ({card}); rerun bit-identical: {same}; "
          f"synchronising calls in the solve: {syncs}")
    print(f"  {ops / n:.1f} device operations an epoch ({busy / n:.4f} ms "
          f"device busy an epoch over {n} epochs); top device operations: "
          + "; ".join(f"{k[:50]} x{c} {t:.3f} ms" for k, c, t in top))
    check(not syncs, "gnss: the f32 solve synchronised with the host")
    check(same, "gnss: the rerun differs")
    check(bool(sol.valid.all()) and bool(sol.vel_valid.all()),
          "gnss: an epoch's position or velocity is not valid")

    host = ref_job.get()
    est = torch.cat([ref + sol.delta.double(),
                     sol.clock_bias.double()[:, None]], -1).cpu().numpy()
    got = {"vel": sol.vel_ecef.double().cpu().numpy(),
           "pdop": sol.pdop.double().cpu().numpy(),
           "hdop": sol.hdop.double().cpu().numpy(),
           "num_sats": sol.num_sats.cpu().numpy()}

    def gaps(state, vel, pdop, hdop, num_sats, keep):
        """Max position, clock, velocity and DOP-ratio gaps over the epochs
        ``keep``, and whether num_sats is equal there."""
        return (np.linalg.norm(est[keep, :3] - state[keep, :3], axis=1).max(),
                np.abs(est[keep, 3] - state[keep, 3]).max(),
                np.linalg.norm(got["vel"][keep] - vel[keep], axis=1).max(),
                max(np.abs(got["pdop"][keep] / pdop[keep] - 1).max(),
                    np.abs(got["hdop"][keep] / hdop[keep] - 1).max()),
                bool(np.array_equal(got["num_sats"][keep], num_sats[keep])))

    def within(g):
        return (g[0] < GNSS_POS_M and g[1] < GNSS_CB_M and g[2] < GNSS_VEL
                and g[3] < GNSS_DOP_RTOL and g[4])

    every = np.ones(E, bool)
    g_loc = gaps(host["local_state"], host["local_vel"], host["local_pdop"],
                 host["local_hdop"], host["local_num_sats"], every)
    agree = (ep.valid.cpu().numpy() == host["used"]).all(1)
    g_run = gaps(host["state"], host["vel"], host["pdop"], host["hdop"],
                 host["num_sats"], agree)
    split = np.nonzero(~agree)[0]
    d_split = np.linalg.norm(est[split, :3] - host["state"][split, :3], axis=1)
    ate = float(np.sqrt(np.mean(np.sum(
        (est[:, :3] - truth.cpu().numpy()) ** 2, 1))))
    for name, g in (("the host's f64 local solve, every epoch", g_loc),
                    (f"the host's f64 run_epochs ({host['sec']:.2f} s), the "
                     f"{int(agree.sum())} epochs whose masks agree", g_run)):
        print(f"  card f32 vs {name}: position max {g[0]:.4g} m (bound "
              f"{GNSS_POS_M}), clock {g[1]:.4g} m (bound {GNSS_CB_M}), "
              f"velocity {g[2]:.4g} m/s (bound {GNSS_VEL}), PDOP/HDOP rtol "
              f"{g[3]:.3g} (bound {GNSS_DOP_RTOL}), num_sats equal {g[4]}")
    print(f"  epochs whose anchored masks differ from run_epochs': "
          f"{split.tolist()} (bound {GNSS_MASK_SPLIT_MAX} epochs), position "
          f"gap there {np.round(d_split, 4).tolist()} m; ATE against the "
          f"truth {ate:.3f} m")
    check(within(g_loc), "gnss: the card's f32 solve is outside the JAX "
          "package's f32-vs-f64 bounds of the host's f64 local solve")
    check(within(g_run) and len(split) <= GNSS_MASK_SPLIT_MAX,
          "gnss: the card's f32 solve is outside the JAX package's "
          "f32-vs-f64 bounds of the host's f64 run_epochs where the masks "
          "agree, or the masks disagree on too many epochs")

    # run_epochs in f64 on the card against the host's
    k = GNSS_F64_EPOCHS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = pipeline.run_epochs(store, iono, *(c[:k] for c in channels), ref,
                               config=cfg)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    dp64 = np.abs(sols.position.state.cpu().numpy()
                  - host["state"][:k]).max()
    dv64 = np.abs(sols.velocity.vel_ecef.cpu().numpy()
                  - host["vel"][:k]).max()
    same_valid = (np.array_equal(sols.position.valid.cpu().numpy(),
                                 host["valid"][:k])
                  and np.array_equal(sols.velocity.valid.cpu().numpy(),
                                     host["vel_valid"][:k]))
    print(f"  run_epochs f64 on the card over epochs 0-{k - 1}: {f64_s:.2f} "
          f"s ({k / f64_s:.1f} epochs/s); against the host's: state max "
          f"{dp64:.3g} m (bound {GNSS_F64_POS_M}), velocity {dv64:.3g} m/s "
          f"(bound {GNSS_F64_VEL}), validity equal {same_valid}")
    check(dp64 < GNSS_F64_POS_M and dv64 < GNSS_F64_VEL and same_valid,
          "gnss: run_epochs in f64 on the card differs from the host's")

    apps = {}
    for name, files in (("gnss_demo", ("gnss_position.csv", "skyplot.jsonl",
                                       "solution.csv")),
                        ("raim_demo", ("raim.csv", "ellipse.jsonl")),
                        ("urban_demo", ("skyplot.jsonl",
                                        "pseudoranges.csv"))):
        tmp = tempfile.TemporaryDirectory()
        rc, stdout, app_s = run_module(f"toyslam_tpu_torch.apps.{name}",
                                       tmp.name)
        wrote = all((Path(tmp.name) / f).is_file()
                    and (Path(tmp.name) / f).stat().st_size > 0
                    for f in files)
        tmp.cleanup()
        apps[name] = app_s
        print(f"  {name} at its defaults ({app_s:.1f} s with the process "
              f"start): exit {rc}, wrote {', '.join(files)}: {wrote}")
        for ln in stdout.splitlines():
            print(f"    {ln}")
        check(rc == 0 and wrote, f"{name} failed its gate or wrote no files")
        if name == "gnss_demo":
            app_ate = float(re.search(r"ENU ATE vs ground truth: ([\d.]+)",
                                      stdout).group(1))
            check(app_ate < GNSS_ATE_M, f"gnss_demo's ATE {app_ate} m")
    return {"epochs_per_s": E / sec, "ops_per_epoch": ops / n,
            "busy_ms_per_epoch": busy / n, "f64_epochs_per_s": k / f64_s,
            "app_s": apps}


def run_chain(*steps):
    """``run_module`` of each (module, *args) in turn; their results."""
    return [run_module(*step) for step in steps]


def bag_phase(dev, gt, cfg, bag_job, app_files):
    """Phase 28: bag-256k's ingest routes, ndt_mapping over it, ScanStream,
    the packer's threads, StageTimer and the bag apps on the card. Returns
    K1-K3's launches of the bag's ndt_mapping."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from toyslam_tpu_torch.core import pcd_io
    from toyslam_tpu_torch.ops import ndt_kernels
    from toyslam_tpu_torch.pipelines import odometry
    from toyslam_tpu_torch.runtime import loader, native, rosbag
    from toyslam_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    write_s = float(bag_job.get()["write_s"])
    d = bag_job.out_dir
    bag, pcds = d / "bag-256k.bag", loader.list_scan_files(d / "pcd")
    S, cap = len(gt), BAG_CAPACITY
    card = card_line()
    print(f"phase 28 bag-256k: {S} scans as PointCloud2 on {BAG_TOPIC} at "
          f"10 Hz, lz4 chunks, {bag.stat().st_size / 1e6:.2f} MB, written "
          f"by rosbag.write_bag (pure Python) in {write_s:.2f} s on the "
          f"host (a process of its own during phases 1-27)")

    # Ingest: four routes, best of INGEST_REPS on the host clock, held
    # byte-equal.
    routes = {
        "bag, C reader": lambda: rosbag.pack_bag_scans(bag, BAG_TOPIC, cap),
        "bag, Python reader": lambda: rosbag.pack_bag_scans(
            bag, BAG_TOPIC, cap, native=False),
        "PCDs, C packer": lambda: loader.load_scan_stack(pcds, cap),
        "PCDs, Python": lambda: loader.load_scan_stack(pcds, cap,
                                                       native=False),
    }
    got, ingest_ms = {}, {}
    for name, fn in routes.items():
        best = np.inf
        for _ in range(INGEST_REPS):
            t0 = time.perf_counter()
            got[name] = fn()
            best = min(best, time.perf_counter() - t0)
        ingest_ms[name] = 1e3 * best / S
    xb, mb, tb, cb = got["bag, C reader"]
    for name, res in got.items():
        same = all(a.tobytes() == b.tobytes() for a, b in zip(res, got[
            "bag, C reader"]))
        check(same, f"ingest route {name!r} differs from the bag's C reader")
    stamps = BAG_T0 + 0.1 * np.arange(S)
    valid = [len(pcd_io.read_pcd(f)) for f in pcds]
    check(len(tb) == S and np.abs(tb - stamps).max() < 1e-6
          and cb.tolist() == valid, "the bag's times or counts are wrong")
    print(f"  ingest, host ms a scan (best of {INGEST_REPS}; {card}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in ingest_ms.items())
          + f"; all four stacks byte-equal (xyzi, mask; times and counts of "
          f"the two bag routes): True; {min(valid)}-{max(valid)} points a "
          f"scan in capacity {cap}")
    small = d / "small_bz2.bag"
    bz = [rosbag.pack_bag_scans(small, BAG_TOPIC, 8192, native=n)
          for n in (True, False)]
    check(all(a.tobytes() == b.tobytes() for a, b in zip(*bz))
          and bz[0][3].tolist() == [5000, 3000],
          "the bz2 bag reads differently through the C and Python readers")
    print("  a bz2 bag through the C reader (libbz2 opened) and the Python "
          "reader: byte-equal")

    # ndt_mapping over the bag's stack, counts set to 0 just before it.
    scans = torch.from_numpy(xb).to(dev)
    masks = torch.from_numpy(mb).to(dev)
    ndt_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mout = odometry.ndt_mapping(scans, masks, MAP_CAPACITY, cfg)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    launch = dict(ndt_kernels.LAUNCHES)
    t0 = time.perf_counter()
    again = odometry.ndt_mapping(scans, masks, MAP_CAPACITY, cfg)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    check(launch["ndt_gather_repack"] > 0 and launch["ndt_terms_packed"] > 0,
          "K2 or K3 was never launched in the bag's mapping")
    check(torch.equal(again.odometry.poses, mout.odometry.poses)
          and torch.equal(again.map_xyzi, mout.map_xyzi),
          "a rerun of the bag's mapping differs")
    check(bool(mout.odometry.converged.all()), "a bag mapping align did "
                                               "not converge")
    poses = mout.odometry.poses.double().numpy()
    gt_rel = np.linalg.inv(gt[0]) @ gt
    ate = np.linalg.norm(poses[:, :3, 3] - gt_rel[:, :3, 3], axis=1)
    pair_err = [float(np.linalg.norm(
        mout.odometry.pairwise[k].double().numpy()[:3, 3]
        - (np.linalg.inv(gt[k - 1]) @ gt[k])[:3, 3])) for k in range(1, S)]
    print(f"  ndt_mapping over the bag (capacity {cap}, map {MAP_CAPACITY}):"
          f" {(S - 1) / again_s:.2f} scans/s ({1e3 * again_s / (S - 1):.2f} "
          f"ms a scan, second run, bit-identical; first run "
          f"{(S - 1) / map_s:.2f}; {card}); launches {launch}; ATE vs "
          f"ground truth max "
          f"{ate.max():.4g} m (bound {ATE_MAX_M}), per-scan relative "
          f"translation error median {np.median(pair_err):.4g} m (bound "
          f"{PAIR_MEDIAN_MAX_M})")
    check(np.isfinite(poses).all() and ate.max() < ATE_MAX_M
          and np.median(pair_err) < PAIR_MEDIAN_MAX_M,
          "the bag's mapping is far from the ground truth")

    # ScanStream over the PCDs into mapping_step, against the same loop
    # over the preloaded stack.
    def stepped(feed):
        state, out_poses = None, []
        t0 = time.perf_counter()
        for x, m in feed:
            if state is None:
                state = odometry.mapping_init(x, m, MAP_CAPACITY, cfg)
                out_poses.append(state.odometry.pose)
            else:
                state, o = odometry.mapping_step(state, x, m, cfg)
                out_poses.append(o[0])
        torch.cuda.synchronize()
        return state, torch.stack(out_poses), time.perf_counter() - t0

    sx, sm = (torch.from_numpy(a).to(dev) for a in got["PCDs, C packer"])
    torch.cuda.synchronize()
    st_state, st_poses, st_s = stepped(zip(sx, sm))
    stream = loader.ScanStream(pcds, cap, device=dev)
    ss_state, ss_poses, ss_s = stepped(stream)
    same = (torch.equal(ss_poses, st_poses)
            and torch.equal(ss_state.map_cloud.xyzi, st_state.map_cloud.xyzi)
            and torch.equal(ss_state.map_cloud.mask, st_state.map_cloud.mask))
    like_batch = (torch.equal(st_poses, mout.odometry.poses)
                  and torch.equal(st_state.map_cloud.xyzi, mout.map_xyzi))
    print(f"  ScanStream (prefetch 2, pinned ring, side-stream copies) into "
          f"mapping_step: {S / ss_s:.2f} scans/s, {1e3 * stream.wait_s:.1f} "
          f"ms of host waiting on the queue in {ss_s:.2f} s; the same loop "
          f"over the preloaded stack {S / st_s:.2f} scans/s ({card}); "
          f"poses and map bit-identical: {same}; both equal the bag's "
          f"ndt_mapping bit for bit: {like_batch}")
    check(same, "ScanStream's mapping differs from the preloaded stack's")
    check(like_batch, "the chained steps differ from the bag's ndt_mapping")

    # The packer's threads: RACE_CALLS calls over the 16 PCDs and the small
    # ones of random header layouts, each equal to the Python packer.
    files = pcds + sorted((d / "race").glob("*.pcd"))
    want = loader.load_scan_stack(files, cap, native=False)
    out = (np.empty_like(want[0]), np.empty_like(want[1]))
    t0 = time.perf_counter()
    failed = differ = 0
    for _ in range(RACE_CALLS):
        try:
            native.pack_scans(files, cap, RACE_THREADS, out=out)
        except ValueError:
            failed += 1
            continue
        differ += not (np.array_equal(out[0].view(np.uint32),
                                      want[0].view(np.uint32))
                       and np.array_equal(out[1], want[1]))
    race_s = time.perf_counter() - t0
    print(f"  pack_scans x {RACE_CALLS}, {RACE_THREADS} threads, "
          f"{len(files)} files ({len(pcds)} of bag-256k's scans, {RACE_SMALL}"
          f" small of random header layouts): {failed} failed, {differ} "
          f"differ from the Python packer ({race_s:.1f} s)")
    check(failed == 0 and differ == 0, "the C packer failed or differed "
                                       "under threads")

    # StageTimer: it waits for the card (a spin queued inside the stage),
    # and around one mapping step it agrees with the host clock.
    timer = profiling.StageTimer()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles = int(10_000_000 * STAGE_SPIN_MS / start.elapsed_time(end))
    holder = []
    with timer.stage("spin", holder):
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        holder.append(torch.ones(1, device=dev) + 1)
    spin_dev = start.elapsed_time(end)
    prev = odometry.mapping_init(sx[S - 2], sm[S - 2], MAP_CAPACITY, cfg)
    holder = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer.stage("mapping_step", holder):
        holder.append(odometry.mapping_step(prev, sx[S - 1], sm[S - 1], cfg))
    torch.cuda.synchronize()
    host_step = 1e3 * (time.perf_counter() - t0)
    summ = timer.summary()
    spin_ms, step_ms = summ["spin"]["total_ms"], summ["mapping_step"][
        "total_ms"]
    print(f"  StageTimer: a stage around a spin of {spin_dev:.2f} ms on "
          f"the card (CUDA events) {spin_ms:.2f} ms; one mapping step "
          f"{step_ms:.3f} ms, the host clock around it and a synchronise "
          f"{host_step:.3f} ms ({card})")
    check(spin_ms >= spin_dev, "StageTimer did not wait for the card")
    check(0.0 <= host_step - step_ms < 1.0, "StageTimer and the host clock "
                                            "disagree")

    # The apps on the card, three chains at once: mapping_demo on a bag of
    # phase 18's six scans; fusion_demo and gnss_demo --write-bag, --bag.
    root = d / "apps"
    fbag, gbag = root / "sensors.bag", root / "meas.bag"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        fm = ex.submit(run_module, "toyslam_tpu_torch.apps.mapping_demo",
                       d / "app.bag", root / "map", "--capacity", cap)
        ff = ex.submit(run_chain, (
            "toyslam_tpu_torch.apps.fusion_demo", root / "fsim",
            "--duration", FUSION_BAG_S, "--write-bag", fbag), (
            "toyslam_tpu_torch.apps.fusion_demo", root / "frep", "--bag",
            fbag))
        fg = ex.submit(run_chain, (
            "toyslam_tpu_torch.apps.gnss_demo", root / "gsim",
            "--write-bag", gbag), (
            "toyslam_tpu_torch.apps.gnss_demo", root / "grep", "--bag",
            gbag))
        (m_rc, m_out, m_s), fus, gns = fm.result(), ff.result(), fg.result()
    apps_s = time.perf_counter() - t0
    check(m_rc == 0, f"mapping_demo on a bag exited {m_rc}")
    tum = [(root / "map" / "trajectory.txt").read_text().splitlines(),
           app_files[0].decode().splitlines()]
    poses_same = [ln.split()[1:] for ln in tum[0]] == [
        ln.split()[1:] for ln in tum[1]]
    map_same = (root / "map" / "map.pcd").read_bytes() == app_files[2]
    bag_t = [float(ln.split()[0]) for ln in tum[0]]
    print(f"  mapping_demo on app.bag ({APP_SCANS} scans, {m_s:.1f} s with "
          f"the process start): trajectory.txt's pose columns equal to phase"
          f" 18's directory run: {poses_same}, map.pcd byte-equal: "
          f"{map_same}; times {bag_t[0]:.1f}..{bag_t[-1]:.1f} from the "
          f"stamps")
    check(poses_same and map_same, "mapping_demo on a bag differs from "
                                   "the directory run")
    check(all(rc == 0 for rc, _, _ in fus), "fusion_demo exited non-zero")
    rep = fus[1][1]
    rmse = float(re.search(r"smoothed vs raw-fix RMSE:\s+([\d.]+) m",
                           rep).group(1))
    print(f"  fusion_demo --duration {FUSION_BAG_S} --write-bag, then --bag "
          f"({fus[0][2]:.1f} s, {fus[1][2]:.1f} s): replay "
          + " | ".join(ln for ln in rep.splitlines()
                       if "keyframes" in ln or "RMSE" in ln)
          + f" (gate < {FUSION_BAG_GATE_M} m)")
    check("GPS keyframes" in rep and rmse < FUSION_BAG_GATE_M,
          f"fusion_demo's bag replay: smoothed vs raw fixes {rmse} m")
    check(all(rc == 0 for rc, _, _ in gns), "gnss_demo exited non-zero")

    def enu(name):
        with open(root / name / "gnss_position.csv") as f:
            rows = list(csv.DictReader(f))
        return [(r["enu_e"], r["enu_n"], r["enu_u"]) for r in rows]

    gsame = enu("gsim") == enu("grep")
    n_ep = re.search(r"bag: (\d+) GnssMeas epochs", gns[1][1])
    print(f"  gnss_demo --write-bag, then --bag ({gns[0][2]:.1f} s, "
          f"{gns[1][2]:.1f} s): {n_ep.group(1) if n_ep else '?'} GnssMeas "
          f"epochs; the replay's ENU positions equal the simulation's: "
          f"{gsame}")
    check(gsame and n_ep is not None, "gnss_demo's bag replay solves to "
                                      "other positions")
    print(f"  the three app chains at once: {apps_s:.1f} s; phase 28: "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return launch


def fleet_smoother_args(dtype, dev):
    """smoother-fleet-64's logs stacked on a lane axis on ``dev``."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import jax_smoother_refs

    logs = [jax_smoother_refs.bench_log(M=FLEET_KF, seed=FLEET_SEED0 + b)
            for b in range(FLEET_LOGS)]
    per = [smoother_args(log, dtype, dev) for log in logs]
    return [torch.stack(parts) for parts in zip(*per)], logs


def smoother_fleet_phase(dev):
    """Phase 29, smoother-fleet-64: sharded_batch_fusion over 64 logs on
    the card in f64 and f32, its host syncs, rate and device operations a
    keyframe round; lanes 0-3 against single-log runs; the chunks."""
    import torch

    from toyslam_tpu_torch.parallel import batch
    from toyslam_tpu_torch.pipelines import batch_fusion

    card = card_line()
    cfg = batch_fusion.BatchFusionConfig()
    K = cfg.window.window_size
    n_marg = FLEET_KF - K
    mesh = [dev]
    runs, stats = {}, {}
    for dtype, chunk, n_logs in ((torch.float64, 64, FLEET_LOGS),
                                 (torch.float32, 64, FLEET_LOGS),
                                 (torch.float32, 16, FLEET_CHUNK16_LOGS)):
        args, logs = fleet_smoother_args(dtype, dev)
        args = [a[:n_logs] for a in args]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, syncs = count_syncs(lambda: batch.sharded_batch_fusion(
            mesh, *args, config=cfg, chunk=chunk))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        name = f"{str(dtype)[6:]} chunk {chunk}"
        runs[name] = out
        eigh = sum(v for k, v in syncs.items() if "estimators/window" in k)
        other = sum(v for k, v in syncs.items()
                    if "estimators/window" not in k)
        stats[name] = {"seconds": sec,
                       "keyframes_per_s": n_logs * FLEET_KF / sec,
                       "syncs": eigh + other}
        print(f"phase 29 smoother-fleet-64 {name}: {n_logs} logs x "
              f"{FLEET_KF} keyframes, window {K}: {sec:.2f} s, "
              f"{n_logs * FLEET_KF / sec:.1f} keyframes/s aggregate "
              f"({card}); synchronising calls by line: {syncs}")
        check(all(bool(torch.isfinite(t).all()) for t in out[:5]),
              f"smoother-fleet-64 {name}: an output is not finite")
        # eigh's one a marginalisation for all lanes of a chunk, nothing else
        check(eigh == n_marg * -(-n_logs // chunk) and other == 0,
              f"smoother-fleet-64 {name}: host syncs other than eigh's one "
              f"a marginalisation round")
    # Device operations a keyframe round: the f32 fleet resumed from its
    # final window over the logs' last keyframes (a full window).
    args32, logs = fleet_smoother_args(torch.float32, dev)
    last = runs["float32 chunk 64"]
    state = batch_fusion.NavState(*(x[:, -1] for x in last[:5]))
    wall, busy, ops, top = device_profile(
        lambda: batch_fusion.batch_fusion_lanes(
            *(a[:, -FLEET_PROFILE_KF:] for a in args32), config=cfg,
            init_window=last.win, init_state=state, initialized=True))
    print(f"  {ops / FLEET_PROFILE_KF:.1f} device operations a keyframe "
          f"round of 64 lanes ({busy / FLEET_PROFILE_KF:.3f} ms device busy "
          f"of {wall / FLEET_PROFILE_KF:.1f} ms wall a round); top: "
          + "; ".join(f"{k[:50]} x{c} {t:.3f} ms" for k, c, t in top[:4]))

    # Lanes 0-3 in f64 against the single-log runs on the card.
    args64, _ = fleet_smoother_args(torch.float64, dev)
    f64 = runs["float64 chunk 64"]
    dev_p, dev_v = [], []
    t0 = time.perf_counter()
    for b in range(FLEET_CHECKED_LANES):
        one = batch_fusion.batch_fusion(*(a[b] for a in args64), config=cfg)
        dev_p.append(float((one.kf_p - f64.kf_p[b]).abs().max()))
        dev_v.append(float((one.kf_v - f64.kf_v[b]).abs().max()))
    single_s = (time.perf_counter() - t0) / FLEET_CHECKED_LANES
    print(f"  lanes 0-{FLEET_CHECKED_LANES - 1} f64 against single-log "
          f"batch_fusion on the card ({single_s:.2f} s a log, "
          f"{FLEET_KF / single_s:.2f} keyframes/s): position "
          f"{max(dev_p):.3g} m, velocity {max(dev_v):.3g} m/s (bound "
          f"{FLEET_LANE_F64_M} m)")
    check(max(dev_p) <= FLEET_LANE_F64_M,
          "smoother-fleet-64: an f64 lane far from its single-log run")
    # f32 lanes: finite (above) and within twice JAX's f32 drift of f64.
    p64 = f64.kf_p.cpu().numpy()
    v64 = f64.kf_v.cpu().numpy()
    for name in ("float32 chunk 64", "float32 chunk 16"):
        o = runs[name]
        n = len(o.kf_p)
        dp = np.linalg.norm(o.kf_p.double().cpu().numpy() - p64[:n], axis=-1)
        dv = np.linalg.norm(o.kf_v.double().cpu().numpy() - v64[:n], axis=-1)
        print(f"  {name} against the f64 lanes: position max "
              f"{dp.max():.4f} m, velocity median {np.median(dv):.4f} m/s "
              f"(bounds {2 * JAX_DRIFT_POS_M:.3f} m, "
              f"{2 * JAX_DRIFT_VEL:.3f} m/s)")
        check(dp.max() <= 2 * JAX_DRIFT_POS_M
              and np.median(dv) <= 2 * JAX_DRIFT_VEL,
              f"smoother-fleet-64 {name}: f32 drifts from f64 more than "
              f"twice as far as the JAX package's")
    a, b = runs["float32 chunk 64"], runs["float32 chunk 16"]
    same = all(torch.equal(x[:FLEET_CHUNK16_LOGS], y)
               for x, y in zip(a[:6], b[:6]))
    chunk_dp = float((a.kf_p[:FLEET_CHUNK16_LOGS] - b.kf_p).abs().max())
    print(f"  chunk 16 against chunk 64 (f32) over lanes 0-"
          f"{FLEET_CHUNK16_LOGS - 1}: bit-identical {same}, position max "
          f"{chunk_dp:.3g} m")
    return {"runs": stats, "device_ops_per_round": ops / FLEET_PROFILE_KF,
            "lane_f64_m": max(dev_p), "single_log_s": single_s}


def _shard_counts(before):
    from toyslam_tpu_torch.ops import ndt_kernels

    return {k: ndt_kernels.LAUNCHES[k] - before.get(k, 0)
            for k in ndt_kernels.LAUNCHES}


def gloo_worker(addr, rank, in_path, out_path):
    """One of phase 29's two processes: its half of the align-65k source
    on cuda:0, the sums all-reduced over Gloo with the other."""
    import torch

    from toyslam_tpu_torch.core.pointcloud import PointCloud
    from toyslam_tpu_torch.parallel import batch
    from toyslam_tpu_torch.registration import ndt

    data = torch.load(in_path)  # on the card it was saved from
    amap = ndt.NDTMap(*data["map"])
    xyzi, mask = data["xyzi"], data["mask"]
    dev = xyzi.device
    half = mask.shape[0] // 2
    mine = PointCloud(xyzi[rank * half:(rank + 1) * half],
                      mask[rank * half:(rank + 1) * half])
    batch.initialize_multihost(addr, 2, rank, timeout=GLOO_TIMEOUT_S)
    batch.initialize_multihost(addr, 2, rank, timeout=GLOO_TIMEOUT_S)
    t0 = time.perf_counter()
    res = batch.sharded_align([dev], amap, mine, None, ndt.NDTConfig())
    sec = time.perf_counter() - t0
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    np.savez(out_path, transform=res.transform.numpy(),
             iterations=res.iterations, evaluations=res.evaluations,
             seconds=sec)


def sharded_align_phase(dev, amap, src):
    """Phase 29, sharded-align and multihost: the align-65k pair split
    over meshes of repeated cuda:0, exact and frozen, against ndt_align;
    every shard's kernel call held to its plain version; then two
    processes joined over Gloo."""
    import socket

    import torch

    from toyslam_tpu_torch.ops import ndt_kernels
    from toyslam_tpu_torch.parallel import batch
    from toyslam_tpu_torch.registration import ndt

    card = card_line()
    launched = {k: 0 for k in ndt_kernels.LAUNCHES}
    modes = {"exact": ndt.NDTConfig(),
             "frozen": ndt.NDTConfig(frozen_linesearch=True,
                                     regather_iterations=4)}
    out = {}
    for mode, cfg in modes.items():
        ref = ndt.ndt_align(amap, src, None, cfg)
        ref_ms, _ = host_ms(lambda: ndt.ndt_align(amap, src, None, cfg),
                            SHARD_TIMING_REPS)
        print(f"phase 29 sharded-align {mode}: unsharded ndt_align "
              f"{ref_ms:.2f} ms/align, iterations {ref.iterations}, "
              f"evaluations {ref.evaluations}, gathers {ref.gathers}")
        for n in SHARD_MESHES:
            mesh = [dev] * n
            before = dict(ndt_kernels.LAUNCHES)
            res = batch.sharded_align(mesh, amap, src, None, cfg)
            counts = _shard_counts(before)
            for k, v in counts.items():
                launched[k] += v
            want = ({"ndt_terms_gathered": res.evaluations * n,
                     "ndt_gather_repack": 0, "ndt_terms_packed": 0}
                    if mode == "exact" else
                    {"ndt_terms_gathered": 0,
                     "ndt_gather_repack": res.gathers * n,
                     "ndt_terms_packed": res.evaluations * n})
            d_t, d_r = pose_diff(res.transform, ref.transform)
            diff = float((res.transform - ref.transform).abs().max())
            calls = []
            with checked_plain_route(calls):
                plain = batch.sharded_align(mesh, amap, src, None, cfg)
            bad = [c for c in calls if not c[3]]
            worst = max(c[2][0] if isinstance(c[2], tuple) else c[2]
                        for c in calls)
            ms, _ = host_ms(lambda: batch.sharded_align(mesh, amap, src,
                                                        None, cfg),
                            SHARD_TIMING_REPS)
            print(f"  [cuda:0] x {n}: {ms:.2f} ms/align ({card}), "
                  f"iterations {res.iterations}, evaluations "
                  f"{res.evaluations}, launches {counts} (expected {want}),"
                  f" host copies {res.host_syncs}; transform vs ndt_align "
                  f"{diff:.3g} ({d_t:.3g} m, {d_r:.3g} rad; bound "
                  f"{SHARD_TOL}); {len(calls)} shard kernel calls held to "
                  f"their plain versions, worst {worst:.3g}, the plain "
                  f"route's iterations {plain.iterations}")
            check(res.converged, f"sharded-align {mode} x{n}: not converged")
            check(counts == want, f"sharded-align {mode} x{n}: launches "
                                  f"{counts}, expected {want}")
            check(res.host_syncs == res.evaluations * n,
                  f"sharded-align {mode} x{n}: not one copy a shard an "
                  f"evaluation")
            check(diff <= SHARD_TOL and res.iterations == ref.iterations,
                  f"sharded-align {mode} x{n}: transform {diff:.3g} from "
                  f"ndt_align or iterations {res.iterations} != "
                  f"{ref.iterations}")
            check(calls and not bad, f"sharded-align {mode} x{n}: a shard's "
                                     f"kernel disagrees with its plain "
                                     f"version: {bad[:3]}")
            out[f"{mode} x{n}"] = {"ms": ms, "iterations": res.iterations,
                                   "launches": counts}
        out[f"{mode} unsharded_ms"] = ref_ms

    # Two processes on cuda:0 over Gloo against one process over
    # [cuda:0] x 2.
    cfg = modes["exact"]
    one = batch.sharded_align([dev, dev], amap, src, None, cfg)
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    torch.save({"map": tuple(amap), "xyzi": src.xyzi, "mask": src.mask},
               d / "in.pt")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = f"localhost:{sock.getsockname()[1]}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--gloo-rank", addr,
         str(rank), str(d / "in.pt"), str(d / f"out{rank}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=Path(__file__).resolve().parent) for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=2 * GLOO_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        raise SmokeFailure("multihost: a Gloo process hung")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"multihost: rank {rank} failed:\n"
                                 f"{log[-2000:]}")
    got = [dict(np.load(d / f"out{rank}.npz")) for rank in range(2)]
    tmp.cleanup()
    diff = max(float(np.abs(g["transform"] - one.transform.numpy()).max())
               for g in got)
    same = all(np.array_equal(g["transform"], one.transform.numpy())
               for g in got)
    print(f"  multihost: two processes on cuda:0 over Gloo, {wall:.1f} s "
          f"wall with their start ({card}); align "
          f"{float(got[0]['seconds']) * 1e3:.1f} ms in rank 0 (the first, "
          f"with its warm-up); iterations "
          f"{[int(g['iterations']) for g in got]} against "
          f"{one.iterations}; transform vs one process over [cuda:0] x 2: "
          f"{diff:.3g} (bit-identical {same})")
    check(all(int(g["iterations"]) == one.iterations for g in got)
          and diff <= SHARD_TOL, "multihost: the two-process align differs "
                                 "from the one-process sharded_align")
    out["multihost_s"] = wall
    return out, launched


def api_check(scan, scan_mask, leaf, n_voxels, ndt_map, card):
    """Phase 2's check of the single-cloud API on the card: ``voxel_ids``
    and ``unique_voxel_slots`` of one scan int for int against the CPU,
    ``eigh3`` of its map's covariances against a host f64 run, and
    ``native.available()``."""
    import torch

    from toyslam_tpu_torch.core import pointcloud
    from toyslam_tpu_torch.ops.eigh3 import eigh3
    from toyslam_tpu_torch.runtime import native

    t0 = time.perf_counter()
    got = pointcloud.voxel_ids(pointcloud.PointCloud(scan, scan_mask), leaf)
    got += pointcloud.unique_voxel_slots(got[0])
    want = pointcloud.voxel_ids(pointcloud.PointCloud(scan.cpu(),
                                                      scan_mask.cpu()), leaf)
    want += pointcloud.unique_voxel_slots(want[0])
    for name, g, w in zip(("vid", "min_b", "div_mul", "unique_ids", "slot",
                           "n_unique"), got, want):
        check(g.is_cuda and g.dtype == torch.int32 and torch.equal(g.cpu(), w),
              f"{name} on the card differs from the CPU")
    check(int(got[5]) == n_voxels, f"{int(got[5])} voxels, the downsample "
                                   f"has {n_voxels}")

    # The map's covariances: the inverses of its valid voxels' icov rows.
    icov = ndt_map.icov6[:, ndt_map.valid].double().cpu().numpy()
    i3 = icov[[0, 1, 2, 1, 3, 4, 2, 4, 5]].T.reshape(-1, 3, 3)
    cov = np.linalg.inv(i3).astype(np.float32)
    w, v = (a.cpu().double().numpy()
            for a in eigh3(torch.from_numpy(cov).to(scan.device)))
    w64, v64 = (a.numpy() for a in eigh3(torch.from_numpy(cov).double()))
    top = np.abs(w64).max(1)
    ev_err = float((np.abs(w - w64).max(1) / top).max())
    recon = v @ (w[:, :, None] * np.swapaxes(v, 1, 2))
    rec_err = float((np.abs(recon - cov).max((1, 2)) / top).max())
    gap = np.stack([np.minimum(np.abs(w64[:, j] - w64[:, k]),
                               np.abs(w64[:, j] - w64[:, 3 - j - k]))
                    for j, k in ((0, 1), (1, 0), (2, 0))], 1) / top[:, None]
    # Sine of each eigenvector's angle to its f64 counterpart (an arccos
    # of the cosine would read the f32 vector's norm as an angle).
    vc, vc64 = np.swapaxes(v, 1, 2), np.swapaxes(v64, 1, 2)
    sines = (np.linalg.norm(np.cross(vc, vc64), axis=-1)
             / np.linalg.norm(vc, axis=-1))[gap >= EIGH3_GAP]
    angle = float(sines.max())
    check(ev_err <= EIGH3_RTOL and rec_err <= EIGH3_RTOL
          and angle <= EIGH3_ANGLE,
          f"eigh3 on the card vs f64: eigenvalues {ev_err:.3g}, "
          f"reconstruction {rec_err:.3g}, angle {angle:.3g} rad")
    check(native.available(), "native.available() is False")
    print(f"phase 2 API check: voxel_ids + unique_voxel_slots of scan 0 "
          f"({scan.shape[0]} points, {leaf} m) on the card: {int(got[5])} "
          f"voxels, every output int for int with the CPU; eigh3 of the "
          f"map's {len(cov)} covariances in f32 vs f64 on the host: "
          f"eigenvalues {ev_err:.3g} and V diag(w) V^T {rec_err:.3g} of the "
          f"largest eigenvalue, eigenvector angle {angle:.3g} rad over "
          f"{sines.size} gapped ones; native.available() True; "
          f"{time.perf_counter() - t0:.2f} s ({card})")


def eigh3_phase(dev):
    """Phase 2's check of the eigensolver: ``eigh3_soa`` through its kernel
    against ``eigh3_soa_plain`` on the card, every eigenvalue and vector
    entry bit for bit and each call one launch, at the main paths' shapes
    (EIGH3_SIZES from stride-9 views of ``[N, 3, 3]``, as LOAM and GICP
    pass them, and the map build's ``[B, V, 6]`` unbound at stride 6), in
    float32 and float64, on ``tests/eigh3_cases.matrices`` (NaN and inf
    rows among them); each rerun bit-identical. Then, in float32 at
    EIGH3_TIMED, the kernel's and the plain version's times and the
    kernel's bound. Returns the kernels line's entries."""
    import torch

    from toyslam_tpu_torch.ops import eigh3, eigh3_kernels

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import eigh3_cases

    ints = {torch.float32: torch.int32, torch.float64: torch.int64}

    def flat(out):
        ev, vec = out
        return torch.stack([t.reshape(-1) for t in (*ev, *vec)])

    def layouts(dtype):
        for n in EIGH3_SIZES:
            a = eigh3_cases.matrices(n, dtype, dev, seed=n)
            yield f"N {n} at stride 9", 9, eigh3_cases.components(a)
        b, v = EIGH3_MAP_SHAPE
        a = eigh3_cases.matrices(b * v, dtype, dev, seed=v)
        yield (f"[{b}, {v}, 6] at stride 6", 6,
               eigh3_cases.map_components(a, b))

    t0 = time.perf_counter()
    max_err, rows = 0.0, []
    for dtype in (torch.float32, torch.float64):
        for label, stride, comps in layouts(dtype):
            check(all(eigh3_kernels.flat_stride(c) == stride for c in comps),
                  f"eigh3 {label}: a component is not at stride {stride}")
            eigh3_kernels.reset_launch_counts()
            got = flat(eigh3.eigh3_soa(*comps))
            again = flat(eigh3.eigh3_soa(*comps))
            check(eigh3_kernels.LAUNCHES["eigh3"] == 2,
                  f"eigh3 {label}: {eigh3_kernels.LAUNCHES} for two calls")
            want = flat(eigh3.eigh3_soa_plain(*comps))
            check(torch.equal(got.view(ints[dtype]), want.view(ints[dtype])),
                  f"eigh3 {label} {dtype}: the kernel is not bit-identical "
                  f"to its plain version")
            check(torch.equal(got.view(ints[dtype]), again.view(ints[dtype])),
                  f"eigh3 {label} {dtype}: a rerun differs")
            both = torch.isfinite(got) & torch.isfinite(want)
            max_err = max(max_err, float((got - want)[both].abs().max()))
            rows.append(f"{label} {str(dtype)[6:]} "
                        f"({int((~torch.isfinite(want)).any(0).sum())} "
                        f"matrices with a NaN or inf output)")
    print(f"phase 2 eigh3 vs plain: bit-identical, one launch a call, rerun "
          f"bit-identical: {'; '.join(rows)} "
          f"({time.perf_counter() - t0:.1f} s)")

    card = card_line()
    sizes = {}
    for n in EIGH3_TIMED:
        comps = eigh3_cases.components(
            eigh3_cases.matrices(n, torch.float32, dev, seed=n))
        b_ms, b_by = bound(n * EIGH3_BYTES_PER_MATRIX,
                           n * EIGH3_FLOPS_PER_MATRIX)
        sizes[n] = {
            "ms": cuda_ms(lambda: eigh3.eigh3_soa(*comps)),
            "plain_ms": cuda_ms(lambda: eigh3.eigh3_soa_plain(*comps)),
            "device_ms": device_ms_per_launch(
                lambda: eigh3.eigh3_soa(*comps), CUDA_NAMES["eigh3"]),
            "bound_ms": b_ms, "bound_by": b_by}
        r = sizes[n]
        print(f"  eigh3 at N {n} ({card}), CUDA events, mean of {REPS} after "
              f"warm-up: kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f} ms a launch), plain {r['plain_ms']:.4f} "
              f"ms, bound {b_ms:.6f} ms ({b_by}; "
              f"{EIGH3_BYTES_PER_MATRIX} bytes and {EIGH3_FLOPS_PER_MATRIX} "
              f"operations a matrix; {b_ms / r['device_ms']:.1%} of the "
              f"device time reached)")
    top = sizes[max(EIGH3_TIMED)]
    return {"max_abs_err": max_err, "ms": (top["ms"], top["plain_ms"]),
            "bound": (top["bound_ms"], top["bound_by"]),
            "device_ms": top["device_ms"], "sizes": sizes}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    from toyslam_tpu_torch.core import pointcloud
    from toyslam_tpu_torch.diag import diag_bf16_concat, gicp_call_ops
    from toyslam_tpu_torch.diag import ndt_eval_ops
    from toyslam_tpu_torch.diag import ndt_odometry_edge
    from toyslam_tpu_torch.diag import profile_gather_modes
    from toyslam_tpu_torch.ops import _cuda, eigh3_kernels, gather_kernels
    from toyslam_tpu_torch.ops import gicp_kernels
    from toyslam_tpu_torch.ops import ndt_kernels, nn_kernels, ranking_kernels
    from toyslam_tpu_torch.pipelines import odometry
    from toyslam_tpu_torch.registration import gicp, icp, ndt
    from toyslam_tpu_torch.runtime import native
    from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    script_t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    refs = HostJob("references")  # f64 host runs for phases 25-26
    gnss_ref = HostJob("gnss")  # phase 27's f64 run_epochs on the host
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # 1. Build, one nvcc per source, all at once.
    t0 = time.perf_counter()
    libs = _cuda.build(ndt_kernels.SOURCE, nn_kernels.SOURCE,
                       gicp_kernels.SOURCE, ranking_kernels.SOURCE,
                       gather_kernels.SOURCE, eigh3_kernels.SOURCE)
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(lib.name for lib in libs)})")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    # The host library (csrc/host: LZF, LZ4, the PCD packer, the bag
    # reader), built by gcc from the checkout's sources; a failure raises.
    t0 = time.perf_counter()
    host_lib = native.build()
    native.load()
    print(f"phase 1 host library: {time.perf_counter() - t0:.2f} s "
          f"({host_lib.name}); bz2 chunks readable (libbz2 opened): "
          f"{native.bz2_available()}")
    check(native.bz2_available(), "libbz2 could not be opened: the C bag "
                                  "reader cannot decode bz2 chunks")

    # Scans: 16 x 262144 rays for odometry, 2 x 65536 for the single aligns.
    t0 = time.perf_counter()
    xyzi, mask, gt = spinning_lidar_scans(0, ODO_SCANS)
    a_xyzi, a_mask, a_gt = spinning_lidar_scans(1, 2, *ALIGN_RAYS,
                                                fov_deg=ALIGN_FOV)
    bag_dir = tempfile.TemporaryDirectory()
    bag_job = HostJob("bag", {"dir": np.array(bag_dir.name), "xyzi": xyzi,
                              "mask": mask})  # phase 28's files
    bag_job.out_dir, bag_job.keep = Path(bag_dir.name), bag_dir
    print(f"scans generated on the host: {time.perf_counter() - t0:.1f} s, "
          f"{xyzi.shape[1]} and {a_xyzi.shape[1]} rays per scan")
    scans = torch.from_numpy(xyzi).to(dev)
    scan_mask = torch.from_numpy(mask).to(dev)
    cfg = odometry.OdometryConfig()
    ds = [pointcloud.voxel_downsample(
        pointcloud.PointCloud(scans[k], scan_mask[k]), cfg.scan_leaf,
        xyzi.shape[1], with_intensity=False) for k in range(ODO_SCANS)]
    counts = [int(c.mask.sum()) for c in ds]
    print(f"0.3 m voxels per scan: min {min(counts)} max {max(counts)} "
          f"(work_capacity {cfg.work_capacity})")
    check(4000 <= min(counts) and max(counts) <= cfg.work_capacity,
          "scan voxel counts outside [4000, work_capacity]")

    # 2. K1-K3 against their plain versions on the card, at the odometry
    #    shapes (N = work_capacity, K = 7, grid 1 << 15).
    src = pointcloud.voxel_downsample(
        pointcloud.PointCloud(scans[1], scan_mask[1]), cfg.scan_leaf,
        cfg.work_capacity, with_intensity=False)
    m = ndt.build_ndt_map(pointcloud.pad_to(ds[0], cfg.work_capacity),
                          cfg.ndt)
    api_check(scans[0], scan_mask[0], cfg.scan_leaf, counts[0], m, card)
    e3 = eigh3_phase(dev)
    rel = np.linalg.inv(gt[0]) @ gt[1]
    p = ndt.se3.matrix_to_pose6(torch.from_numpy(rel)).numpy().astype(
        np.float32)
    lane, ev, params, (h, nvid, okm) = one_lane(m, src, cfg.ndt, p)
    table = m.hash_table
    k1_args = (params, ev.xyz, ev.mask, table, m.min_b, m.div, ev.inv_leaf,
               ev.offsets)
    print(f"phase 2 shapes: N {ev.xyz.shape[1]} K {ev.K} pairs {h.numel()} "
          f"table {tuple(table.shape)}")
    err = {}
    stats = ndt_kernels.ndt_gather_repack(table, h, nvid, okm)
    lane.stats = stats[None]  # the frozen evaluation of phase 6
    stats_plain = ndt_kernels.ndt_gather_repack_plain(table, h, nvid, okm)
    torch.cuda.synchronize()
    check(torch.equal(stats.view(torch.int32), stats_plain.view(torch.int32)),
          "K2 ndt_gather_repack is not bit-identical to its plain version")
    err["ndt_gather_repack"] = float((stats - stats_plain).abs().max())
    gate_share = float(stats[9].mean())
    for name, got, want in (
            ("ndt_terms_packed",
             ndt_kernels.ndt_terms_packed(params, ev.xyz, stats),
             ndt_kernels.ndt_terms_packed_plain(params, ev.xyz, stats)),
            ("ndt_terms_gathered",
             ndt_kernels.ndt_terms_gathered(*k1_args),
             ndt_kernels.ndt_terms_gathered_plain(*k1_args))):
        rel_err, err[name] = terms_err(got, want, NDT_GROUPS)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite sums")
        check(rel_err <= TERMS_RTOL,
              f"{name}: relative error {rel_err:.3g} > {TERMS_RTOL}")
        print(f"  {name}: max rel err {rel_err:.3g} (bound {TERMS_RTOL}), "
              f"max abs err {err[name]:.3g}")
    print(f"phase 2 kernels vs plain: ok (K2 bit-identical, gate open on "
          f"{gate_share:.3f} of pairs)")

    # NDT path: counts reset, then the exact align and the odometry.
    ndt_kernels.reset_launch_counts()
    eigh3_kernels.reset_launch_counts()
    a_src = [pointcloud.voxel_downsample(pointcloud.PointCloud(
        torch.from_numpy(a_xyzi[k]).to(dev),
        torch.from_numpy(a_mask[k]).to(dev)), 0.1) for k in range(2)]
    a_counts = [int(c.mask.sum()) for c in a_src]
    acfg = ndt.NDTConfig()
    amap = ndt.build_ndt_map(a_src[0], acfg)
    res = ndt.ndt_align(amap, a_src[1], torch.eye(4), acfg)
    a_rel = np.linalg.inv(a_gt[0]) @ a_gt[1]
    a_err = float(np.linalg.norm(res.transform.numpy()[:3, 3]
                                 - a_rel[:3, 3]))
    print(f"phase 3 exact align: {a_counts} points after the 0.1 m "
          f"downsample, converged {res.converged}, iterations "
          f"{res.iterations}, evaluations {res.evaluations}, host syncs "
          f"{res.host_syncs}, translation error vs ground truth {a_err:.4g} m")
    check(res.converged, "exact align did not converge")
    check(bool(torch.isfinite(res.transform).all())
          and a_err < np.linalg.norm(a_rel[:3, 3]),
          "exact align did not improve on its identity guess")
    # The same align in f64 on the CPU (plain versions; equals the JAX
    # package to ~1e-15 there): the card's f32 kernel route must land on it.
    t0 = time.perf_counter()
    cpu_pair = [pointcloud.PointCloud(c.xyzi.double().cpu(), c.mask.cpu())
                for c in a_src]
    res64 = ndt.ndt_align(ndt.build_ndt_map(cpu_pair[0], acfg), cpu_pair[1],
                          np.eye(4), acfg)
    d_t, d_r = pose_diff(res.transform, res64.transform)
    print(f"  vs the f64 CPU align of the same pair ({time.perf_counter() - t0:.1f}"
          f" s; iterations {res64.iterations}, evaluations "
          f"{res64.evaluations}): {d_t:.4g} m, {d_r:.4g} rad (bounds "
          f"{ALIGN64_TOL_M} m, {ALIGN64_TOL_RAD} rad)")
    check(res64.converged and d_t <= ALIGN64_TOL_M
          and d_r <= ALIGN64_TOL_RAD,
          "exact align on the card far from the f64 CPU align")

    t0 = time.perf_counter()
    out = odometry.ndt_odometry(scans, scan_mask, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(ndt_kernels.LAUNCHES)
    ndt_eigh3 = eigh3_kernels.LAUNCHES["eigh3"]
    print(f"launches in the NDT path: {launches}; eigh3 {ndt_eigh3} (one a "
          f"map build: the exact align's and {ODO_SCANS - 1} odometry steps')")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the NDT path was never launched")
    check(ndt_eigh3 == ODO_SCANS, "the NDT path did not launch eigh3 once a "
                                  "map build")
    check(bool(out.converged.all()), "an odometry align did not converge")
    poses = out.poses.double().numpy()
    check(np.isfinite(poses).all(), "non-finite odometry poses")
    gt_rel = np.linalg.inv(gt[0]) @ gt
    ate = np.linalg.norm(poses[:, :3, 3] - gt_rel[:, :3, 3], axis=1)
    pair_err = [float(np.linalg.norm(
        out.pairwise[k].double().numpy()[:3, 3]
        - (np.linalg.inv(gt[k - 1]) @ gt[k])[:3, 3]))
        for k in range(1, ODO_SCANS)]
    print(f"phase 4 odometry: {ODO_SCANS} scans in {first_s:.2f} s (first "
          f"run), iterations {out.iterations.tolist()}, evaluations "
          f"{out.evaluations.tolist()}, gathers {out.gathers.tolist()}")
    print(f"  ATE vs ground truth: rmse {np.sqrt((ate ** 2).mean()):.4g} m, "
          f"max {ate.max():.4g} m; per-scan relative translation error "
          f"median {np.median(pair_err):.4g} m, max {max(pair_err):.4g} m")
    check(ate.max() < ATE_MAX_M and np.median(pair_err) < PAIR_MEDIAN_MAX_M,
          "odometry far from the ground truth")

    ndt_names = ("ndt_terms_gathered", "ndt_gather_repack",
                 "ndt_terms_packed")
    # The plain route, with K1 and K3 also run on each of its evaluations'
    # inputs: the sums held to the plain sums along the plain route's own
    # path, a check that no convergence decision of an align can flip.
    along = []
    with ndt_odometry_edge.plain_route(along):
        out_plain = odometry.ndt_odometry(scans, scan_mask, cfg)
    along_err = max(e[1] for e in along)
    print(f"  K1/K3 vs plain at each of the plain route's {len(along)} "
          f"evaluations: max rel err {along_err:.3g} (bound {TERMS_RTOL})")
    check(len(along) == int(out_plain.evaluations.sum())
          and along_err <= TERMS_RTOL,
          "K1/K3 disagree with plain along the plain odometry's path")
    pp = out_plain.poses.double().numpy()
    dt_max = float(np.abs(pp[:, :3, 3] - poses[:, :3, 3]).max())
    dr_max = max(rotation_angle(a[:3, :3], b[:3, :3])
                 for a, b in zip(pp, poses))
    print(f"  kernels vs plain versions on the card: max {dt_max:.3g} m, "
          f"{dr_max:.3g} rad (bounds {PAIRS_TOL_M} m, {PAIRS_TOL_RAD} rad)")
    check(dt_max <= PAIRS_TOL_M and dr_max <= PAIRS_TOL_RAD,
          "kernel and plain odometry disagree")

    # 5. Determinism (and the timed odometry run).
    t0 = time.perf_counter()
    out2 = odometry.ndt_odometry(scans, scan_mask, cfg)
    torch.cuda.synchronize()
    odo_s = time.perf_counter() - t0
    check(torch.equal(out2.poses, out.poses), "rerun poses differ")
    print("phase 5 determinism: rerun poses bit-identical")

    # K1 against its plain version at the shape the exact align gives it.
    alane, aev, aparams, ah = one_lane(amap, a_src[1], acfg,
                                       res.pose6.numpy())
    ak1 = (aparams, aev.xyz, aev.mask, amap.hash_table, amap.min_b, amap.div,
           aev.inv_leaf, aev.offsets)
    rel_err, abs_err = terms_err(ndt_kernels.ndt_terms_gathered(*ak1),
                                 ndt_kernels.ndt_terms_gathered_plain(*ak1),
                                 NDT_GROUPS)
    err["ndt_terms_gathered"] = max(err["ndt_terms_gathered"], abs_err)
    print(f"  ndt_terms_gathered at the exact-align shape (N "
          f"{aev.xyz.shape[1]}, K {aev.K}, table "
          f"{tuple(amap.hash_table.shape)}): max rel err {rel_err:.3g}, "
          f"max abs err {abs_err:.3g}")
    check(rel_err <= TERMS_RTOL,
          f"ndt_terms_gathered at the exact-align shape: relative error "
          f"{rel_err:.3g} > {TERMS_RTOL}")

    # 6. NDT timings, K1's hash at the exact-align shape, the bounds and the
    #    device operations of one evaluation.
    card = card_line()
    ms = {
        "ndt_gather_repack": (
            cuda_ms(lambda: ndt_kernels.ndt_gather_repack(table, h, nvid,
                                                          okm)),
            cuda_ms(lambda: ndt_kernels.ndt_gather_repack_plain(
                table, h, nvid, okm))),
        "ndt_terms_packed": (
            cuda_ms(lambda: ndt_kernels.ndt_terms_packed(params, ev.xyz,
                                                         stats)),
            cuda_ms(lambda: ndt_kernels.ndt_terms_packed_plain(
                params, ev.xyz, stats))),
    }
    ms["ndt_terms_gathered"] = (
        cuda_ms(lambda: ndt_kernels.ndt_terms_gathered(*ak1)),
        cuda_ms(lambda: ndt_kernels.ndt_terms_gathered_plain(*ak1)))
    akn = ah[0].numel()
    kn = h.numel()
    # The least work: K1 hashes every valid point (the transform), reads
    # the gate bytes (16 of 64) of each table row an in-bounds pair of one
    # touches and the stats of each row an open pair touches (48 in all),
    # does the rest of the per-point part once a point with an open pair
    # and the per-pair part once an open pair; K3 reads the gate of every
    # pair and the other nine stats of the open ones, and does the
    # per-point part once a point with an open pair and the per-pair part
    # once an open pair.
    a_valid = int(aev.mask.sum())
    a_gate = ndt_kernels.ndt_gather_repack_plain(amap.hash_table,
                                                 *ah)[9] > 0.5
    a_open_pairs = int(a_gate.sum())
    a_open_points = int(a_gate.view(aev.K, -1).any(0).sum())
    a_rows = int(torch.unique(ah[0][ah[2]]).numel())
    a_open_rows = int(torch.unique(ah[0][a_gate]).numel())
    gate = stats[9] > 0.5
    open_pairs = int(gate.sum())
    open_points = int(gate.view(ev.K, -1).any(0).sum())
    k2_rows = int(torch.unique(h[okm]).numel())
    k2_open_rows = int(torch.unique(h[gate]).numel())
    bounds = {
        "ndt_terms_gathered": bound(
            nbytes(aparams, aev.xyz, aev.mask, amap.min_b, amap.div,
                   aev.offsets) + 16 * a_rows + 32 * a_open_rows + 28 * 4,
            NDT_FLOPS_TRANSFORM * a_valid
            + (NDT_FLOPS_PER_POINT - NDT_FLOPS_TRANSFORM) * a_open_points
            + NDT_FLOPS_PER_PAIR * a_open_pairs),
        # K2 reads the gate of each row an in-bounds pair touches and the
        # stats of each row an open pair touches, not the whole table.
        "ndt_gather_repack": bound(nbytes(h, nvid, okm) + 16 * k2_rows
                                   + 32 * k2_open_rows + 10 * 4 * kn, 0),
        "ndt_terms_packed": bound(
            nbytes(params, ev.xyz) + 4 * kn + 36 * open_pairs + 28 * 4,
            NDT_FLOPS_PER_POINT * open_points
            + NDT_FLOPS_PER_PAIR * open_pairs),
    }
    # The yardstick of the offset-major design: every input in full (the
    # whole table and K1's h/nvid/okm) and both parts on every pair.
    per_pair_before = NDT_FLOPS_PER_POINT + NDT_FLOPS_PER_PAIR
    offset_major_bounds = {
        "ndt_terms_gathered": bound(
            nbytes(aparams, aev.xyz, amap.hash_table, *ah) + 28 * 4,
            per_pair_before * akn),
        "ndt_terms_packed": bound(nbytes(params, ev.xyz, stats) + 28 * 4,
                                  per_pair_before * kn),
    }
    library = {name: None for name in ndt_names}
    launch_dev_ms = {
        "ndt_terms_gathered": device_ms_per_launch(
            lambda: ndt_kernels.ndt_terms_gathered(*ak1),
            CUDA_NAMES["ndt_terms_gathered"]),
        "ndt_gather_repack": device_ms_per_launch(
            lambda: ndt_kernels.ndt_gather_repack(table, h, nvid, okm),
            CUDA_NAMES["ndt_gather_repack"]),
        "ndt_terms_packed": device_ms_per_launch(
            lambda: ndt_kernels.ndt_terms_packed(params, ev.xyz, stats),
            CUDA_NAMES["ndt_terms_packed"]),
    }
    print(f"phase 6 timings ({card}), CUDA events, mean of {REPS} after "
          f"warm-up; device time per launch from torch.profiler over {REPS} "
          f"calls:")
    print("  ndt_terms_gathered at the exact-align shape; the others at the "
          "phase-2 odometry shape")
    for name in ndt_names:
        print(f"  {name}: kernel {ms[name][0]:.4f} ms (device "
              f"{launch_dev_ms[name]:.4f} ms a launch), plain "
              f"{ms[name][1]:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]})")
    print(f"  bounds from {NDT_FLOPS_PER_POINT} flops a point "
          f"({NDT_FLOPS_TRANSFORM} of them the transform) and "
          f"{NDT_FLOPS_PER_PAIR} a pair: K1 {a_valid} valid points "
          f"(transformed and hashed), {a_open_points} with an open gate, "
          f"{a_open_pairs} open of {a_valid * aev.K} pairs of valid points, "
          f"{a_rows} table rows touched, {a_open_rows} of them open; K3 "
          f"{open_points} points with an open gate, {open_pairs} open of "
          f"{kn} pairs; K2 {k2_rows} table rows touched, {k2_open_rows} "
          f"open, of {table.shape[0]}")
    for name, (b_ms, b_by) in offset_major_bounds.items():
        print(f"  {name}: bound {bounds[name][0]:.4f} ms ({bounds[name][1]}; "
              f"{bounds[name][0] / launch_dev_ms[name]:.1%} of the device "
              f"time reached); offset-major yardstick ({per_pair_before} "
              f"flops on every pair, every input in full) {b_ms:.4f} ms "
              f"({b_by}; {b_ms / launch_dev_ms[name]:.1%})")
    evals = {"exact (K1)": ndt_eval_ops.profile_evaluation(
                 alane, res.pose6.numpy()),
             "frozen (K3)": ndt_eval_ops.profile_evaluation(lane, p,
                                                            frozen=True)}
    for (label, r), name in zip(evals.items(), ("ndt_terms_gathered",
                                                 "ndt_terms_packed")):
        print(f"  one {label} evaluation, _LaneEvaluator.derivs at one lane "
              f"under "
              f"torch.profiler: {r['ops']} device operations, "
              f"{r['device_ms']:.4f} ms device time: {r['by_name']}")
        launched = sum(c for key, c in r["by_name"].items()
                       if CUDA_NAMES[name] in key)
        check(r["ops"] == 3 and launched == 1,
              f"one {label} evaluation is not 3 device operations, one of "
              f"them {CUDA_NAMES[name]}")
    align_ms, r = host_ms(
        lambda: ndt.ndt_align(amap, a_src[1], torch.eye(4), acfg))
    syncs = out2.host_syncs[1:].double()
    print(f"  odometry: {(ODO_SCANS - 1) / odo_s:.2f} scans/s "
          f"({1e3 * odo_s / (ODO_SCANS - 1):.2f} ms/scan incl. downsample "
          f"and map build, host clock, second run)")
    print(f"  exact align: {align_ms:.2f} ms/align (mean of 5, host clock), "
          f"{r.host_syncs} host syncs")
    print(f"  host syncs per odometry align: mean {float(syncs.mean()):.2f}, "
          f"max {int(syncs.max())}")

    # 7. K4-K6 against their plain versions on the card, at the shapes of
    #    the registration path: the 0.1 m pair padded to REG_CAPACITY.
    reg = [pointcloud.pad_to(c, REG_CAPACITY) for c in a_src]
    check(max(a_counts) <= REG_CAPACITY, "the pair does not fit its capacity")
    source, target = reg[1], reg[0]
    gcfg = gicp.GICPConfig()
    prob = gicp._problem(source, target, gcfg)
    n, m_cols = prob.src.shape[0], prob.tgt_t.shape[1]
    eye3 = torch.eye(3, device=dev)
    zero3 = torch.zeros(3, device=dev)
    moved = prob.src  # the first outer iteration, from the identity guess
    valid = prob.mask
    print(f"phase 7 registration kernels vs plain (N {n}, M {m_cols}, "
          f"{int(valid.sum())} and {int(target.mask.sum())} valid points):")
    k4_counts = {}
    for label, tsq_op in (("GICP operands, 1e9 sentinel", prob.tsq),
                          ("ICP operands, 1e30 sentinel",
                           torch.where(target.mask, prob.tsq, 1e30))):
        # The path's own instance (no counts) and the counting one.
        best, idx = nn_kernels.nearest_neighbor(moved, prob.tgt_t, tsq_op)
        cbest, cidx, cnt = nn_kernels.nearest_neighbor(moved, prob.tgt_t,
                                                       tsq_op, counts=True)
        pbest, pidx = nn_kernels.nearest_neighbor_plain(moved, prob.tgt_t,
                                                        tsq_op)
        same = all(torch.equal(i, pidx)
                   and torch.equal(b.view(torch.int32),
                                   pbest.view(torch.int32))
                   for b, i in ((best, idx), (cbest, cidx)))
        cf = cnt.double()
        stats = {k: {"mean": float(cf[sel].mean()),
                     "p99": float(cf[sel].quantile(0.99)),
                     "max": int(cf[sel].max())}
                 for k, sel in (("valid", valid), ("padded", ~valid))
                 if bool(sel.any())}
        k4_counts[label] = stats
        print(f"  nearest_neighbor ({label}): bit-identical on all {n} rows, "
              f"with and without counts: {same} ({int((idx != pidx).sum())} "
              f"and {int((cidx != pidx).sum())} indices differ); "
              f"rescored columns per row {stats}")
        check(same, f"K4 nearest_neighbor is not bit-identical to its plain "
                    f"version ({label})")
        err["nearest_neighbor"] = max(err.get("nearest_neighbor", 0.0),
                                      float((best - pbest).abs().max()))

    xyz_t = prob.tgt_t.T.contiguous()  # the target cloud's own k-NN
    tsq_all = (xyz_t * xyz_t).sum(1)
    nd = nn_kernels.neg_dist_bf16(xyz_t, tsq_all, prob.tgt_t, prob.tsq)
    nd_plain = nn_kernels.neg_dist_bf16_plain(xyz_t, tsq_all, prob.tgt_t,
                                              prob.tsq)
    tv = target.mask
    diff = (nd.float() - nd_plain.float())[tv][:, tv]
    ulp = 2.0 ** -8 * nd_plain.float()[tv][:, tv].abs()
    share5 = float((diff.abs() <= ulp).double().mean())
    err["neg_dist_bf16"] = float(diff.abs().max())
    print(f"  neg_dist_bf16: within 1 bf16 ulp on {share5:.6f} of valid x "
          f"valid entries (bound {NN_SHARE}), max abs err "
          f"{err['neg_dist_bf16']:.3g}, bit-identical: "
          f"{torch.equal(nd.view(torch.int16), nd_plain.view(torch.int16))}")
    check(share5 >= NN_SHARE, "K5 neg_dist_bf16 disagrees with its plain "
                              "version")
    del nd, nd_plain, diff, ulp

    q, m6, w = gicp._correspondences(prob, eye3, zero3)
    gparams = torch.cat([eye3.reshape(-1), zero3])
    k6_args = (gparams, prob.xyz, q, m6, w)
    k6_out = gicp_kernels.gicp_terms(*k6_args).clone()
    k6_same = torch.equal(k6_out.view(torch.int32),
                          gicp_kernels.gicp_terms(*k6_args).view(torch.int32))
    rel_err, err["gicp_terms"] = terms_err(
        k6_out, gicp_kernels.gicp_terms_plain(*k6_args), GN_GROUPS)
    print(f"  gicp_terms: max rel err {rel_err:.3g} (bound {TERMS_RTOL}), "
          f"max abs err {err['gicp_terms']:.3g}, {int(w.sum())} "
          f"correspondences within {gcfg.max_correspondence_distance} m; "
          f"rerun bit-identical: {k6_same}")
    check(rel_err <= TERMS_RTOL, "K6 gicp_terms disagrees with its plain "
                                 "version")
    check(k6_same, "K6 gicp_terms is not bit-identical on a rerun")
    upd_args = (k6_out, gparams, gcfg.damping)
    upd_out = gicp_kernels.gicp_update(*upd_args).clone()
    upd_same = torch.equal(
        upd_out.view(torch.int32),
        gicp_kernels.gicp_update(*upd_args).view(torch.int32))
    err["gicp_update"], upd_ok = kernel_err(
        "gicp_update", upd_args, upd_out,
        gicp_kernels.gicp_update_plain(*upd_args))
    print(f"  gicp_update: max abs err {err['gicp_update']:.3g} (bound "
          f"{UPDATE_STEP_RTOL} of the step, "
          f"{float((upd_out - gparams).abs().max()):.3g}, plus "
          f"{UPDATE_ULPS} ulps); rerun bit-identical: {upd_same}")
    check(upd_ok, "gicp_update disagrees with its plain version")
    check(upd_same, "gicp_update is not bit-identical on a rerun")

    # Registration path: counts reset, then one GICP and one ICP align.
    nn_kernels.reset_launch_counts()
    gicp_kernels.reset_launch_counts()
    eigh3_kernels.reset_launch_counts()
    g_res = gicp.gicp_align(source, target, None, gcfg)
    g_launch = {**nn_kernels.LAUNCHES, **gicp_kernels.LAUNCHES,
                **eigh3_kernels.LAUNCHES}
    i_res = icp.icp_align(source, target)
    reg_launches = {**nn_kernels.LAUNCHES, **gicp_kernels.LAUNCHES,
                    **eigh3_kernels.LAUNCHES}
    print(f"phase 8 registration path (0.1 m pair, capacity {REG_CAPACITY}):")
    print(f"  launches: gicp_align {g_launch}; with icp_align "
          f"{reg_launches}")
    check(all(v > 0 for v in reg_launches.values()),
          "a kernel of the registration path was never launched")
    check(g_launch["eigh3"] == 2, "gicp_align did not launch eigh3 once for "
                                  "each cloud's covariances")
    truth_t, truth_r = pose_diff(a_rel, np.eye(4))
    for name, r in (("gicp_align", g_res), ("icp_align", i_res)):
        e_t, e_r = pose_diff(r.transform, a_rel)
        print(f"  {name}: converged {r.converged}, iterations "
              f"{r.iterations}, host syncs {r.host_syncs}, error "
              f"{float(r.error):.5g}; vs ground truth {e_t:.4g} m, "
              f"{e_r:.4g} rad (identity guess {truth_t:.4g} m, "
              f"{truth_r:.4g} rad)")
        check(r.converged, f"{name} did not converge")
        check(bool(torch.isfinite(r.transform).all()) and e_t < truth_t,
              f"{name} did not improve on its identity guess")
    check(pose_diff(g_res.transform, a_rel)[1] < truth_r,
          "gicp_align did not improve the rotation of its identity guess")

    nn_plain = {name: getattr(nn_kernels, name + "_plain")
                for name in nn_kernels.LAUNCHES}
    gicp_plain = {name: getattr(gicp_kernels, name + "_plain")
                  for name in gicp_kernels.LAUNCHES}
    with mock.patch.multiple(nn_kernels, **nn_plain), mock.patch.multiple(
            gicp_kernels, **gicp_plain):
        g_plain = gicp.gicp_align(source, target, None, gcfg)
        i_plain = icp.icp_align(source, target)
    for name, r, rp, (tol_m, tol_rad) in (
            ("gicp_align", g_res, g_plain, (GICP_TOL_M, GICP_TOL_RAD)),
            ("icp_align", i_res, i_plain, (ICP_TOL_M, ICP_TOL_RAD))):
        d_t, d_r = pose_diff(r.transform, rp.transform)
        print(f"  {name} kernels vs plain versions on the card: {d_t:.3g} "
              f"m, {d_r:.3g} rad (bounds {tol_m} m, {tol_rad} rad), "
              f"iterations {r.iterations} vs {rp.iterations}")
        check(d_t <= tol_m and d_r <= tol_rad,
              f"{name}: kernel and plain routes disagree")
    _, control_syncs = count_syncs(lambda: None)
    g_again, g_syncs = count_syncs(
        lambda: gicp.gicp_align(source, target, None, gcfg))
    i_again, i_syncs = count_syncs(lambda: icp.icp_align(source, target))
    check(torch.equal(g_again.transform, g_res.transform)
          and torch.equal(i_again.transform, i_res.transform),
          "rerun registration poses differ")
    print("  rerun poses bit-identical")
    print(f"  control, the sync count around no work: {control_syncs}")
    for name, r, where in (("gicp_align", g_res, g_syncs),
                           ("icp_align", i_res, i_syncs)):
        print(f"  {name}: {sum(where.values())} synchronising calls "
              f"reported by torch's sync debug mode ({r.host_syncs} "
              f"planned), by line: {where}")

    R0, t0_ = eye3, zero3
    nd_op = nn_kernels.neg_dist_bf16(xyz_t, tsq_all, prob.tgt_t, prob.tsq)
    probes = {
        "one inner GN step (K6, gicp_update)":
            lambda: gicp._gn_step(prob.xyz, q, m6, w, gparams, gcfg.damping),
        "K4 correspondences + Mahalanobis":
            lambda: gicp._correspondences(prob, R0, t0_),
        "covariances (K5 + topk + eigh3)":
            lambda: gicp.compute_covariances(prob.src, prob.mask, 20, 1e-3),
        "K5 alone": lambda: nn_kernels.neg_dist_bf16(
            xyz_t, tsq_all, prob.tgt_t, prob.tsq),
        "torch.topk (k 20) of K5's operand": lambda: torch.topk(nd_op, 20),
        "pose host-to-device copy (non-blocking)":
            lambda: torch.eye(4).to(dev, non_blocking=True),
        "control: 1500 one-element additions (launches only)":
            lambda: [zero3.add(1.0) for _ in range(1500)],
    }
    print("  host wait while the card spins 50 ms on earlier work (~50 ms "
          "means the call waits on the device):")
    for name, fn in probes.items():
        print(f"    {name}: {host_wait_ms(fn):.3f} ms")
    del nd_op
    _, cov_syncs = count_syncs(
        lambda: gicp.compute_covariances(prob.src, prob.mask, 20, 1e-3))
    print(f"  compute_covariances alone: synchronising calls by line: "
          f"{cov_syncs}")

    # 9. Registration timings.
    card = card_line()
    tgt_xyz = prob.tgt_t.T.contiguous()
    ssq = (moved * moved).sum(1)
    a4 = torch.cat([2.0 * moved, -ssq[:, None]], 1)
    b4 = torch.cat([prob.tgt_t, torch.ones(1, m_cols, device=dev)], 0)
    neg_tsq = -prob.tsq
    ms["nearest_neighbor"] = (
        cuda_ms(lambda: nn_kernels.nearest_neighbor(moved, prob.tgt_t,
                                                    prob.tsq)),
        cuda_ms(lambda: nn_kernels.nearest_neighbor_plain(
            moved, prob.tgt_t, prob.tsq)))
    ms["neg_dist_bf16"] = (
        cuda_ms(lambda: nn_kernels.neg_dist_bf16(moved, ssq, prob.tgt_t,
                                                 prob.tsq)),
        cuda_ms(lambda: nn_kernels.neg_dist_bf16_plain(
            moved, ssq, prob.tgt_t, prob.tsq)))
    ms["gicp_terms"] = (
        cuda_ms(lambda: gicp_kernels.gicp_terms(*k6_args)),
        cuda_ms(lambda: gicp_kernels.gicp_terms_plain(*k6_args)))
    ms["gicp_update"] = (
        cuda_ms(lambda: gicp_kernels.gicp_update(*upd_args)),
        cuda_ms(lambda: gicp_kernels.gicp_update_plain(*upd_args)))
    library["nearest_neighbor"] = cuda_ms(
        lambda: torch.cdist(moved, tgt_xyz).argmin(1))
    library["neg_dist_bf16"] = cuda_ms(
        lambda: torch.addmm(neg_tsq, a4, b4).to(torch.bfloat16))
    library["gicp_terms"] = None
    library["gicp_update"] = None
    k4_bytes = nbytes(moved, prob.tgt_t, prob.tsq) + 8 * n
    bounds["nearest_neighbor"] = bound(
        k4_bytes, NN_MMA_FLOPS_PER_PAIR * n * m_cols, PEAK_BF16_FLOPS)
    k4_f32_bound = bound(k4_bytes, NN_FLOPS_PER_PAIR * n * m_cols)[0]
    bounds["neg_dist_bf16"] = bound(
        nbytes(moved, ssq, prob.tgt_t, prob.tsq) + 2 * n * m_cols,
        NN_FLOPS_PER_PAIR * n * m_cols)
    bounds["gicp_terms"] = bound(nbytes(*k6_args) + 27 * 4,
                                 GICP_FLOPS_PER_PAIR * n)
    # 27 sums and 12 params in, 12 params out.
    bounds["gicp_update"] = bound(nbytes(k6_out, gparams) + 12 * 4,
                                  GICP_UPDATE_FLOPS)
    launch_dev_ms["nearest_neighbor"] = device_ms_per_launch(
        lambda: nn_kernels.nearest_neighbor(moved, prob.tgt_t, prob.tsq),
        CUDA_NAMES["nearest_neighbor"])
    launch_dev_ms["neg_dist_bf16"] = device_ms_per_launch(
        lambda: nn_kernels.neg_dist_bf16(moved, ssq, prob.tgt_t, prob.tsq),
        CUDA_NAMES["neg_dist_bf16"])
    launch_dev_ms["gicp_terms"] = device_ms_per_launch(
        lambda: gicp_kernels.gicp_terms(*k6_args), CUDA_NAMES["gicp_terms"])
    launch_dev_ms["gicp_update"] = device_ms_per_launch(
        lambda: gicp_kernels.gicp_update(*upd_args),
        CUDA_NAMES["gicp_update"])
    # K6 as a call: its device operations, their device time queued behind
    # a spin, the host's cost of issuing it, and an empty launch of its grid.
    costs = gicp_call_ops.call_costs(
        lambda: gicp_kernels.gicp_terms(*k6_args), dev)
    k6_ops = costs["call"]["ops"] / costs["calls"]
    check(k6_ops == 1, f"a K6 call is {k6_ops:g} device operations: "
                       f"{costs['call']['by_name']}")
    k6_extra = {
        "ops_per_call": k6_ops,
        "device_ms_per_call": costs["device_ms_per_call"],
        "host_ms_per_call": costs["host_ms_per_call"],
        "empty_launch_ms": device_ms_per_launch(
            lambda: gicp_kernels.empty_launch(n, dev), "gicp_empty_kernel")}
    print(f"phase 9 registration timings ({card}), CUDA events, mean of "
          f"{REPS} after warm-up, at N = M = {n}; TF32 off for the plain "
          f"and library calls:")
    k4_dev = launch_dev_ms["nearest_neighbor"]
    print(f"  nearest_neighbor device time {k4_dev:.4f} ms a launch (before "
          f"the tensor-core redesign: {K4_CUDA_CORE_MS} ms, NVIDIA H100 80GB "
          f"HBM3 at 700 W); bound, its tensor-core screen (2 x 16-deep mma a "
          f"pair at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s), "
          f"{bounds['nearest_neighbor'][0]:.4f} ms "
          f"({bounds['nearest_neighbor'][0] / k4_dev:.1%} of it reached); "
          f"for comparison, the plain version's f32 count ("
          f"{NN_FLOPS_PER_PAIR} a pair at {PEAK_F32_FLOPS / 1e12:.0f} "
          f"TFLOP/s) {k4_f32_bound:.4f} ms ({k4_f32_bound / k4_dev:.1%})")
    print(f"  gicp_terms as a call: {k6_ops:g} device operation, "
          f"{k6_extra['device_ms_per_call']:.4f} ms of device time a call "
          f"({gicp_call_ops.REPS} calls queued behind a spin), "
          f"{k6_extra['host_ms_per_call']:.4f} ms of host time a call "
          f"({gicp_call_ops.REPS} calls issued); an empty kernel on its grid "
          f"({gicp_kernels.blocks(n)} x {gicp_kernels.THREADS}) "
          f"{k6_extra['empty_launch_ms']:.4f} ms a launch")
    for name, lib_name in (("nearest_neighbor", "cdist + argmin"),
                           ("neg_dist_bf16", "addmm + to(bfloat16)"),
                           ("gicp_terms", None), ("gicp_update", None)):
        lib_txt = (f", library ({lib_name}) {library[name]:.4f} ms"
                   if lib_name else ", no library call")
        print(f"  {name}: kernel {ms[name][0]:.4f} ms (device "
              f"{launch_dev_ms[name]:.4f} ms a launch), plain "
              f"{ms[name][1]:.4f} ms{lib_txt}, bound {bounds[name][0]:.4f} "
              f"ms ({bounds[name][1]})")
    gicp_ms, _ = host_ms(lambda: gicp.gicp_align(source, target, None, gcfg))
    cov_ms, _ = host_ms(lambda: gicp._problem(source, target, gcfg))
    icp_ms, _ = host_ms(lambda: icp.icp_align(source, target))
    print(f"  gicp_align: {gicp_ms:.2f} ms/align (mean of 5, host clock), of "
          f"which {cov_ms:.2f} ms set-up (covariances of both clouds); "
          f"{g_res.iterations} outer iterations")
    print(f"  icp_align: {icp_ms:.2f} ms/align (mean of 5, host clock), "
          f"{i_res.iterations} iterations")
    for name, fn in (
            ("gicp_align",
             lambda: gicp.gicp_align(source, target, None, gcfg)),
            ("icp_align", lambda: icp.icp_align(source, target))):
        wall, busy, n_launch, rows = device_profile(fn)
        print(f"  torch.profiler, one {name}: wall {wall:.2f} ms, device "
              f"busy {busy:.2f} ms ({100 * busy / wall:.1f} %), "
              f"{n_launch} device operations; top by device time:")
        for key, calls, dev_ms in rows:
            print(f"    {dev_ms:.3f} ms in {calls} calls: {key[:90]}")

    launches.update(reg_launches)

    # 10. D1 against its plain version at the diagnostic's full shape, then
    #     the diagnostic itself (counts reset just before it).
    d1_n = diag_bf16_concat.N_FULL
    s_np, t_np = diag_bf16_concat.inputs(d1_n)
    s = torch.from_numpy(s_np).to(dev)
    tt = torch.from_numpy(np.ascontiguousarray(t_np.T)).to(dev)
    modes = {}
    print(f"phase 10 D1 split_dot vs plain at {d1_n} x {d1_n} (bound "
          f"{SPLIT_RTOL:.3g} of the largest |s.t| for the split modes; "
          f"highest bit-identical):")
    for mode in ranking_kernels.MODES:
        got = ranking_kernels.split_dot(s, tt, mode)
        want = ranking_kernels.split_dot_plain(s, tt, mode)
        same = float((got.view(torch.int32) == want.view(torch.int32))
                     .double().mean())
        diff = float((got - want).abs().max())
        rel = diff / float(want.abs().max())
        check(bool(torch.isfinite(got).all()), f"split_dot {mode}: non-finite")
        print(f"  {mode}: bit-identical share {same:.6f}, max abs diff "
              f"{diff:.4g}, relative to the largest |s.t| {rel:.4g}")
        if mode == "highest":
            check(same == 1.0, "split_dot highest is not bit-identical to "
                               "its plain version")
        check(rel <= SPLIT_RTOL, f"split_dot {mode}: {rel:.3g} > "
                                 f"{SPLIT_RTOL:.3g} from its plain version")
        modes[mode] = {"bit_identical_share": same, "max_abs_err": diff}
        del got, want
    # The assumption under K4's margin, on the same mma: concat9 against the
    # f64 sum of its own split products, with rows at 1e9 as well.
    ts = tt[:, :2048].contiguous()
    big = s[:2048].clone()
    big[::4] = pointcloud.PAD_COORD
    big[1::4, 0] = -pointcloud.PAD_COORD
    for label, rows in (("+-120 m", s[:2048]), ("rows at 1e9", big)):
        ratio = float(ranking_kernels.sum_error(ranking_kernels.split_dot(
            rows, ts, "concat9"), rows, ts, "concat9").max())
        print(f"  concat9 vs the exact sum of its bf16 products, 2048 x 2048 "
              f"({label}): max 2^{np.log2(ratio):.3f} of the sum of their "
              f"magnitudes (K4 assumes <= 2^{np.log2(MMA_SUM_RTOL):.0f})")
        check(ratio <= MMA_SUM_RTOL, "the tensor core's sum misses by more "
                                     "than K4's margin assumes")
    del ts, big
    ranking_kernels.reset_launch_counts()
    d1 = diag_bf16_concat.run(d1_n, "cuda", REPS)
    d1_launch = dict(ranking_kernels.LAUNCHES)
    print(f"  diag_bf16_concat ({d1['device']}): launches {d1_launch}")
    check(all(v > 0 for v in d1_launch.values()),
          "a mode of D1 was never launched in the diagnostic")
    card = card_line()
    print(f"  timings ({card}), CUDA events, mean of {REPS} after warm-up; "
          f"library: one torch.mm of the f32-upcast split operands, TF32 "
          f"off; error vs the f64 oracle on the {diag_bf16_concat.N_ACC} "
          f"slab:")
    d1_bytes = nbytes(s, tt) + 4 * d1_n * d1_n
    for mode in ranking_kernels.MODES:
        ops = ([(s, tt)] if mode == "highest" else
               ranking_kernels.split_operands(s, tt, "concat9"
                                              if mode == "3pass" else mode))
        a, b = ops[0]
        t_bytes = d1_bytes / PEAK_BYTES_S
        peak = PEAK_F32_FLOPS if mode == "highest" else PEAK_BF16_FLOPS
        t_ops = D1_FLOPS_PER_ENTRY[mode] * d1_n * d1_n / peak
        modes[mode].update(
            launches=d1_launch[mode],
            max_rel_err_f64=d1[mode]["max_rel_err"],
            ms=d1[mode]["ms_per_pass"],
            plain_ms=cuda_ms(lambda m=mode: ranking_kernels.split_dot_plain(
                s, tt, m)),
            library_ms=cuda_ms(lambda a=a, b=b: torch.mm(a, b)),
            device_ms=device_ms_per_launch(
                lambda m=mode: ranking_kernels.split_dot(s, tt, m),
                "highest_kernel" if mode == "highest"
                else "split_mma_kernel"),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        r = modes[mode]
        print(f"  {mode}: max_rel_err {r['max_rel_err_f64']:.4g}; kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f} ms a launch), "
              f"plain {r['plain_ms']:.4f} ms, library (K "
              f"{a.shape[1]}) {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    del s, tt, ops, a, b
    # The kernels line gives D1's slowest mode; every mode is under "modes".
    slowest = max(modes, key=lambda k: modes[k]["ms"])
    launches["split_dot"] = sum(d1_launch.values())
    err["split_dot"] = max(r["max_abs_err"] for r in modes.values())
    ms["split_dot"] = (modes[slowest]["ms"], modes[slowest]["plain_ms"])
    library["split_dot"] = modes[slowest]["library_ms"]
    bounds["split_dot"] = (modes[slowest]["bound_ms"],
                           modes[slowest]["bound_by"])
    launch_dev_ms["split_dot"] = modes[slowest]["device_ms"]

    # 11. D2 against its plain version at the fleet's shape, then the
    #     diagnostic itself (counts reset just before it).
    table_np, ids_np, _ = profile_gather_modes.inputs()
    gtab = torch.from_numpy(table_np).to(dev)
    gids = torch.from_numpy(ids_np).to(dev)
    rows = gids.numel()
    got = gather_kernels.lane_row_sum(gids, gtab)
    want = gather_kernels.lane_row_sum_plain(gids, gtab)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "D2 lane_row_sum is not bit-identical to its plain version")
    err["lane_row_sum"] = float((got - want).abs().max())
    print(f"phase 11 D2 lane_row_sum vs plain at {tuple(gtab.shape)} tables, "
          f"ids {tuple(gids.shape)}: bit-identical")
    gather_kernels.reset_launch_counts()
    d2 = profile_gather_modes.run(device="cuda")
    launches["lane_row_sum"] = gather_kernels.LAUNCHES["lane_row_sum"]
    print(f"  profile_gather_modes ({d2['device']}): launches "
          f"{gather_kernels.LAUNCHES}")
    check(launches["lane_row_sum"] > 0, "D2 was never launched in the "
                                        "diagnostic")
    check(d2["kernel_matches"] and d2["flat_matches"],
          "profile_gather_modes: a mode disagrees")
    bounds["lane_row_sum"] = bound(nbytes(gids, gtab) + 4 * rows,
                                   15 * rows)
    ms["lane_row_sum"] = (
        d2["kernel_ns_per_row"] * rows / 1e6,
        cuda_ms(lambda: gather_kernels.lane_row_sum_plain(gids, gtab)))
    library["lane_row_sum"] = d2["batched_ns_per_row"] * rows / 1e6
    launch_dev_ms["lane_row_sum"] = device_ms_per_launch(
        lambda: gather_kernels.lane_row_sum(gids, gtab),
        CUDA_NAMES["lane_row_sum"])
    card = card_line()
    print(f"  ns/row ({card}), CUDA events, mean of {REPS} calls after "
          f"warm-up; bound {1e6 * bounds['lane_row_sum'][0] / rows:.4f} "
          f"ns/row ({bounds['lane_row_sum'][1]}: ids, sums and tables once; "
          f"the gathered rows are {64 * rows / 1e6:.1f} MB of L2 traffic):")
    for key, value in d2.items():
        if key.endswith("_ns_per_row"):
            print(f"    {key}: {value:.4f}")
    d2_cold_ms = d2["kernel_cold_ns_per_row"] * rows / 1e6
    print(f"  kernel {ms['lane_row_sum'][0]:.4f} ms (device "
          f"{launch_dev_ms['lane_row_sum']:.4f} ms a launch; "
          f"{d2_cold_ms:.4f} ms with the L2 cache flushed before each "
          f"call), "
          f"plain {ms['lane_row_sum'][1]:.4f} ms, library (batched indexing) "
          f"{library['lane_row_sum']:.4f} ms, bound "
          f"{bounds['lane_row_sum'][0]:.4f} ms")
    del got, want, gtab, gids

    map_launch, golden_phase, app_files = mapping_path(
        scans, scan_mask, xyzi, mask, cfg, out, a_xyzi, a_mask)
    app_launch, search_args = align_app_phase(dev, a_xyzi, a_mask, a_gt)
    search_phase(dev, *search_args)
    slam_launch = icp_slam_phase(dev)
    fus_launch, tick_ms = fusion_phase(dev, scans, scan_mask, out)
    new_paths = {
        "align_app_launches": app_launch,
        "icp_slam_launches": slam_launch,
        "fusion_launches": fus_launch,
    }
    uwb_phase()
    fleet = fleet_phase(dev, tick_ms)
    golden_phase()
    loam_summary = loam_phase(dev, refs)
    smoother_phase(dev, refs)
    gnss_phase(dev, gnss_ref)
    bag_launch = bag_phase(dev, gt, cfg, bag_job, app_files)
    t0 = time.perf_counter()
    fleet_smoother = smoother_fleet_phase(dev)
    shard, shard_launch = sharded_align_phase(dev, amap, a_src[1])
    print(f"phase 29: {time.perf_counter() - t0:.1f} s; the whole script "
          f"{time.perf_counter() - script_t0:.1f} s")

    err["eigh3"] = e3["max_abs_err"]
    ms["eigh3"] = e3["ms"]
    bounds["eigh3"] = e3["bound"]
    library["eigh3"] = None
    launch_dev_ms["eigh3"] = e3["device_ms"]

    card = card_line()
    print(card)
    kernels = [{
        "name": name, "route": "cuda", "source": source_path,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": err[name], "ms": ms[name][0], "plain_ms": ms[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": library[name], "device_ms": launch_dev_ms[name],
    } for name, (source_path, replaces) in KERNELS.items()]
    kernels[list(KERNELS).index("split_dot")]["modes"] = modes
    kernels[list(KERNELS).index("nearest_neighbor")]["rescored_per_row"] = (
        k4_counts)
    kernels[list(KERNELS).index("gicp_terms")].update(k6_extra)
    kernels[list(KERNELS).index("lane_row_sum")]["cold_ms"] = d2_cold_ms
    kernels[list(KERNELS).index("eigh3")].update(
        sizes=e3["sizes"], ndt_path_launches=ndt_eigh3,
        mapping_launches=map_launch["eigh3"],
        loam_launches={k: v["eigh3_launches"]
                       for k, v in loam_summary.items()})
    for name in ndt_names:  # the mapping path's own run
        kernels[list(KERNELS).index(name)]["mapping_launches"] = (
            map_launch[name])
        kernels[list(KERNELS).index(name)]["bag_mapping_launches"] = (
            bag_launch[name])  # phase 28
    for key, counts in new_paths.items():  # phases 19, 21 and 22
        for name in NEW_PATH_KERNELS:
            kernels[list(KERNELS).index(name)][key] = counts.get(name, 0)
    for name, extra in fleet.items():  # phase 24
        kernels[list(KERNELS).index(name)].update(extra)
    for name in ndt_names:  # phase 29, every mesh and mode
        kernels[list(KERNELS).index(name)]["sharded_align_launches"] = (
            shard_launch[name])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--host-job"]:
        host_job(*sys.argv[2:5])
        sys.exit(0)
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_worker(sys.argv[2], int(sys.argv[3]), *sys.argv[4:6])
        sys.exit(0)
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(2)
    finally:
        for job in JOBS:
            job.stop()
