#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gymnasium_robotics_tpu_torch) on one CUDA
card and check it: the quickest proof that the port starts on the GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit; nothing is caught).
The CPU plain path's steps of the references of phases 13, 24, 28, 31,
36, 39, 41, 45 and 50 run in REF_WORKERS spawned processes while the
card's phases go on; their checks run at the end, in phase 53:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles every kernel from csrc/ (one nvcc per source, in
     parallel) and prints the build seconds and ptxas' register report;
  PointMaze_UMaze-v3 (the chol and Newton kernels at nv = 2):
  3. main path: registry.make("PointMaze_UMaze-v3", num_envs=8192), reset,
     then 320 steps with random actions, past max_episode_steps=300 so every
     env auto-resets; the kernels' launch counters are zeroed just before
     and read just after, and must equal 2 Cholesky and 1 Newton launch per
     step (and no narrowphase launch); prints ms/step and env-steps/s;
  4. trace: 20 more steps of the same env timed on the host clock, then 20
     traced with torch.profiler; prints kernels per step, device busy time
     per step (the union of kernel intervals), the device's idle share of
     the traced wall time and device time by kernel name;
  5. reference: the same env stepped on the card and, through the plain
     versions, on the CPU from one carried-across state must agree;
  6. kernels: each kernel against its plain PyTorch version on the card at
     B = 8192 (random inputs from a numpy seed, and the main path's own
     rows, where balls touch walls), with CUDA-event times of the kernel,
     the plain version and, for the Cholesky, torch.linalg.solve_ex;
  AntMaze_UMaze-v5 (all four kernels: chol and Newton at nv = 14,
  topk_select at two shapes, the narrowphase):
  7. main path: registry.make("AntMaze_UMaze-v5", num_envs=2048,
     max_episode_steps=10), reset, 13 steps with random actions, so every
     env auto-resets; per step 20 chol, 20 Newton, 40 topk_select (20 of
     each shape) and 20 narrowphase launches; prints ms/step and
     env-steps/s;
  8. trace: 2 steps traced, as in phase 4;
  9. reference: 8 envs on the card and on the CPU plain path from one
     carried-across state: within 2e-4 after 1 env step; the error after 2
     steps is printed, not gated (contact dynamics are chaotic);
  10. kernels: each AntMaze kernel against its plain version at B = 2048, on
     random inputs (forced ties for topk_select) and on the arrays of a
     state with the legs pressed into the walls (some capsule-box rows
     must penetrate), with CUDA-event times of the kernel, the plain version
     and, where one PyTorch call computes the same function, that call;
     the Cholesky also held to its plain version run in float64 on the
     pressed state's qM (within 2e-4, or no further than twice the float32
     plain version); the narrowphase also timed on each group kind alone;
  FetchPush-v4 (the narrowphase with plane-hull, plane-box and box-box,
  topk_select at (3, 85) -> 8 and (2, 169) -> 24, chol and Newton at
  nv = 21; box-hull and hull-hull run with MPR as plain PyTorch):
  11. main path: registry.make("FetchPush-v4", num_envs=2048,
     max_episode_steps=3), reset, 4 steps with random actions, so every env
     auto-resets; per step 40 chol, 20 Newton, 40 topk_select (20 of each
     shape) and 20 narrowphase launches; prints ms/step and env-steps/s;
  12. trace: 1 step traced, as in phase 4 (device activity only), with the
     launches counted during it; the traced step is a 4-substep step (its
     20 substeps cut to 4, and dt with them: trace's ``window``; so are
     the later Fetch, hand, FK, HandReach and kitchen traces: a full step
     of theirs holds 0.16-0.57M kernels, which take the profiler tens of
     seconds to minutes to hand over), so its numbers do not compare with
     a full step's;
  13. reference: 4 envs stepped twice on the card from a seeded reset, then
     once more on the card and on the CPU plain path from the carried-across
     state: within 2e-4 after that step;
  14. kernels: each FetchPush kernel against its plain version at B = 2048,
     on the main path's arrays and on a pressed state (the object against
     the fingers, the arm in the table, on the floor and folded onto
     itself), printing per group kind how many envs have a penetrating
     row; every kernel row of the table is compared (distances on their own
     scale, frames NaN-equal); the Cholesky also on the Euler's damped
     system; the Newton solve is held on each set to the plain version run
     in float64 (within 2e-4, or no further than twice the float32 plain
     version), and so is the Cholesky on qM and the damped system of the
     main path's and the pressed state; with the times as in phase 10;
  FetchPush-v4 under Option.fk_kernel=True (the FK kernel beside the four
  above):
  15. main path: registry.make("FetchPush-v4", num_envs=2048,
     max_episode_steps=2) with the env's model set to
     with_options(fk_kernel=True), reset, 3 steps with random actions, so
     every env auto-resets; per step 22 FK launches (the 20 substeps'
     forwards, the blocked gripper's refresh, the auto-reset's fresh
     state) beside 40 chol, 20 Newton, 40 topk_select and 20 narrowphase;
     prints ms/step and env-steps/s, then a 1-step trace as in phase 12;
     Each FK call site (a forward, the gripper refresh, the auto-reset's
     state, a whole env step) is then traced on its own, alone and after
     one leading kernel, the fk_kernel launches in the trace printed
     beside those counted, and the poses the site's last FK wrote held
     within 2e-4 of the plain version; then 50 launches traced back to
     back;
  16. reference and kernel: for the main path's state and one action seed
     (cut from two states and seeds to keep the run's time), one physics
     step with
     the FK kernel, the default (pointer-jumping) FK and the level pass,
     held on 64 envs to the default path run in float64 on the CPU: the FK
     kernel path's median env within 2e-4 and its largest env error no
     more than twice the level pass's (which it computes operation for
     operation; FetchPush's float32 solve moves a few envs far for
     rounding-sized input changes), or 2e-4; one env step (20 substeps),
     FK kernel against default FK, at least 90 % of envs within 2e-4, the
     level pass's share and every spread printed; the FK kernel against
     its plain version (the level pass) on the main path's poses and on
     random poses, all eleven fields, every env within 2e-4, with
     CUDA-event times of both; then at the edges of its launch (B = 1, 33
     and 2047, qpos batch-leading) on the main path's poses;
  The single env (registry.make_gym, the per-env path: the nv = 2 Newton's
  determinant route):
  17. main path: make_gym("PointMaze_UMaze-v3") on the card, a seeded
     parity reset, 310 steps with random actions (past the 300-step limit:
     truncated from step 300 on, no auto-reset); per step 2 chol and 1
     newton_nv2 launch and no newton launch; prints ms/step;
  18. reference: the card's single env against the CPU's (device="cpu")
     over 30 steps from the same parity reset, pushed into a wall;
  19. AntMaze_UMaze-v5 and FetchPush-v4 through make_gym, 1 step each
     (GYM_STEPS_SHORT, cut from 3 to keep the run's time), with
     their kernels' launches counted (Newton at nv = 14 and 21: the per-env
     path keeps the fused Newton there);
  20. kernel: newton2_kernel's determinant route (solve_newton_nv2)
     against its plain version at B = 8192 on the rows of phase 3's
     PointMaze batch (the rows the per-env path builds) and on random rows,
     held to the plain version run in float64 as the nv = 21 Newton is,
     with CUDA-event times, also at B = 1 (the single env's own shape);
  HandManipulateBlockRotateXYZ-v1 (chol and Newton at nv = 36, 272 rows,
  topk_select at (2, 160) -> 16; the unpruned table, box-hull with MPR as
  plain PyTorch; tendons and touch sensors):
  22. main path: registry.make("HandManipulateBlockRotateXYZ-v1",
     num_envs=1024, max_episode_steps=3), reset (the initial settle of a
     pool of 16 poses an env, one batch of 16384, 200 substeps; its
     seconds printed), 4 steps with random actions, so every env
     auto-resets; per step 40 chol (the smooth solve and the Euler's damped
     velocity solve, each substep), 20 Newton and 20 topk_select launches,
     no narrowphase; prints ms/step and env-steps/s;
  23. trace: 1 step traced, as in phase 12, with the launches counted
     during it;
  24. reference: 32 envs stepped once on the card, on the CPU plain path
     and on the CPU plain path in float64, from the main path's state
     (full-range actions) and from settled hands (fresh resets from the
     pool, actions of amplitude 0.1); per env the largest relative error
     over the observation and sensordata. The hand's float32 solve is
     ill-conditioned (the coupling tendons' rows sit at their limits): the
     CPU's own float32 path leaves most envs more than 2e-4 from float64
     after one env step, so the card is held to the float64 path: its
     median env within 2e-4 of it, or no further than twice the CPU
     float32 path's median env; medians, 90th percentiles, maxima and the
     shares within 2e-4 printed;
  25. kernels: each hand kernel against its plain version at B = 1024 on
     random inputs (forced ties for topk_select), on the main path's arrays
     and on a pressed state (the block on the fingertips, in the palm, in
     the forearm's hull; every joint past a limit): topk_select's indices
     equal; the Cholesky within 2e-4 on random systems and on every set
     held to the plain version run in float64 (within 2e-4, or no further
     than twice the float32 plain version); the Newton solve held to the
     plain version run in float64 env by env (the median env within 2e-4,
     or no further than twice the float32 plain version's median env);
     with the times as in phase 10;
  26. the single env: make_gym("HandManipulateBlock_ContinuousTouchSensors-
     v1", parity=True) on the card, a seeded parity reset (its settle), 1
     step (GYM_STEPS_SHORT); launches per step as in phase 22 and 92 touch
     readings in the observation;
  FetchSlide-v4 (B4's plane-cylinder, cylinder-box and cylinder-hull
  kinds, topk_select at (4, 85) -> 8 and (2, 177) -> 24) and FetchReach-v4
  (chol and Newton at nv = 15, topk_select at (3, 85) -> 8 and
  (2, 156) -> 24):
  27. main path: registry.make("FetchSlide-v4", num_envs=2048,
     max_episode_steps=3), reset, 4 steps with random actions, so every env
     auto-resets; per step 40 chol, 20 Newton, 40 topk_select (20 of each
     shape) and 20 narrowphase launches; prints ms/step, env-steps/s and
     the shapes, then a 1-step trace as in phase 12 with the launches
     counted during it;
  28. reference: as phase 13, within 2e-4; where a state squeezes a
     puck between the welded gripper and the table (float32 rounding alone
     moves that solve), the card held instead to the CPU path in float64,
     no further from it than twice the CPU float32 path;
  29. kernels: topk_select at both shapes as in phase 14; the narrowphase on
     the main path's picks and on pressed pucks (under the gripper link,
     tipped and upright on the floor, against the fingers, at random
     orientations against the link, so that the envs pick different hulls),
     every kernel row within 2e-4 of the plain version, each new kind alone
     bit for bit the whole table's rows, timed on the whole table and on
     each new kind alone (GroupTable.only), with the plain versions' times;
  30. main path: registry.make("FetchReach-v4", ...) as phase 27, without
     the trace (FetchSlide's stands for both, and the run keeps its time);
  31. reference: as phase 28;
  32. kernels: topk_select at (2, 156) -> 24; the Cholesky and the Newton
     solve at nv = 15 on random systems, the main path's and a state with
     the fingers pressed 0-4 mm into the table, held to their plain
     versions in float64 as at nv = 21, timed, with solve_ex beside the
     Cholesky;
  33. make_gym("FetchSlide-v4") and make_gym("FetchReach-v4"): a parity
     reset and 1 step each (GYM_STEPS_SHORT), launches per step as in
     phase 27;
  The Adroit family (B4's capsule-capsule, capsule-cylinder,
  cylinder-cylinder and sphere-capsule kinds, the whole pruned table inside
  the kernel; chol and Newton at nv = 30 (Door, Pen), 33 (Hammer) and 36
  (Relocate); topk_select at each task's two shapes, ADROIT_IDS):
  34. main path: registry.make("AdroitHandDoor-v1", num_envs=1024,
     max_episode_steps=5), reset, 6 steps with random actions, so every env
     auto-resets and draws a new door; per step 10 chol, 5 Newton, 10
     topk_select (5 of each shape) and 5 narrowphase launches; prints
     ms/step and env-steps/s;
  35. trace: 1 step traced, as in phase 12, with the launches counted
     during it and the port's kernels' share of device busy;
  36. reference: 8 envs of the main path's state stepped once on the card,
     on the CPU plain path and on it in float64, held as the hand's (phase
     24): the card's median env within 2e-4 of the float64 path or no
     further than twice the CPU float32 path's median env;
  37. kernels: topk_select at Door's shapes as in phase 14; the
     narrowphase on the main path's state, on pressed hands (fingers bent
     into the handle) and on jumbled geoms (every geom at a random pose in
     a 4 cm cube), every kernel row within 2e-4 of the plain version, each
     new kind alone bit for bit the whole table's rows, timed whole, by
     kind and on each new kind alone; the Cholesky and the Newton solve at
     nv = 30 on random systems, the main path's and the pressed state's,
     held to their plain versions in float64 (the Newton env by env: the
     median env as at nv = 36, and every env finite in both within
     max(2e-4, 2x the float32 plain version's error), or, past that,
     within 2x the float32 plain version's spread over inputs perturbed by
     1e-6, newton_spread; the envs that overflow in both counted), timed,
     with solve_ex beside the Cholesky;
  38. make_gym("AdroitHandDoor-v1") (the per-env path): a parity reset and
     3 steps, launches per step as in phase 34;
  39. AdroitHandHammer-v1, AdroitHandPen-v1 and AdroitHandRelocate-v1 x
     1024: 3 steps each (limit 2), launches and shapes as in phase 34, a
     1-step reference as in phase 36, the narrowphase on each table's main,
     pressed (fingers in the hammer, the pen, the ball) and jumbled states
     as in phase 37, topk_select at each shape; Hammer's B1 and B2 at
     nv = 33 as in phase 37, Relocate's sphere-capsule kind alone;
  HandReach-v3 (chol and Newton at nv = 24, 272 rows; the unpruned table,
  topk_select at the hand's (2, 160) -> 16):
  40. main path: registry.make("HandReach-v3", num_envs=1024,
     max_episode_steps=3), reset, 4 steps with random actions, so every env
     auto-resets and draws a new goal; per step 40 chol, 20 Newton and 20
     topk_select launches, no narrowphase; prints ms/step and env-steps/s,
     then a trace as in phase 12;
  41. reference: 32 envs of the main path's state stepped once, held as
     the hand's (phase 24);
  42. kernels: the Cholesky and the Newton solve at nv = 24 on random
     systems, the main path's and pressed hands (every joint drawn from
     its range widened past both limits), held as at nv = 30 (phase 37);
  43. make_gym("HandReach-v3"), parity reset and 1 step (GYM_STEPS_SHORT),
     launches per step
     as in phase 40;
  FrankaKitchen-v1 (B4's capsule-hull kind and the kitchen's whole pruned
  table, topk_select at its two shapes, chol and Newton at nv = 29 with 188
  rows and 8 Newton iterations):
  44. main path: registry.make("FrankaKitchen-v1", num_envs=512,
     max_episode_steps=1), reset, 2 steps with random actions, so every env
     auto-resets (the limit of 280 cut to 1, printed; cut from 3 steps to
     keep the run's time); per step 80 chol, 40
     Newton, 80 topk_select (40 of each shape) and 40 narrowphase launches;
     prints ms/step and env-steps/s, then a trace as in phase 12 (4 of its
     40 substeps);
  45. reference: 8 envs stepped once through step_with_values with the
     same host-drawn noise on the card, on the CPU plain path and on it in
     float64, from two states: the main path's, held as the hand's (phase
     24: the kettle rests on the stove on stiff contact rows whose float32
     solve moves with rounding, so the card is held to float64 by its
     median env), and a fresh reset with the arm moving and the kettle
     lifted 5 cm (it falls free; the card within 2e-4 of the CPU float32
     path in every env); the task masks equal;
  46. kernels: the narrowphase on the main path's state, on pressed arms
     (the arm's joints turned at random into the cabinets, the counter and
     the kettle; no draw thrown away, the envs whose forward overflows
     counted) and on jumbled geoms, every kernel row through
     table_f64_gate as in phase 37, capsule-hull alone bit for bit the
     whole table's rows, timed whole, by kind and alone; topk_select at
     both shapes; the Cholesky and the Newton solve at nv = 29 as in phase
     37;
  47. make_gym("FrankaKitchen-v1", parity=True), the per-env path on the
     card: a seeded parity reset and a step; launches per step as in phase
     44; the step within 2e-4 of step_with_values given the next draws of
     the reset's np_random sequence (the adapter's step-time hook);
  The locomotion family (B1 and B2 at nv = 3, 4, 5, 6, 9, 11 and 23, B1
  at nv = 14 past 96 rows; the unpruned tables, sphere-sphere and the
  fluid model in plain PyTorch):
  48. main path: registry.make("HalfCheetah-v5", num_envs=8192,
     max_episode_steps=4), reset, 6 steps with random actions, so every
     env auto-resets; per step 10 chol (the smooth solve and the Euler's
     damped velocity solve, 5 substeps) and 5 Newton launches, no
     narrowphase or topk_select; prints ms/step and env-steps/s, then a
     whole-step trace as in phase 4;
  49. the other ten v5 models x 8192 (Ant, Hopper, Walker2d, Swimmer,
     Humanoid, HumanoidStandup, InvertedPendulum, InvertedDoublePendulum,
     Reacher, Pusher; RK4 models 4 forwards a substep) and the 17 legacy
     v2/v3 IDs x 1024: 3 and 2 steps, the limit cut to 2 and 1 (every env
     resets), launches per step as the model's integrator and damping
     give them, each model's rows and newton_tile_kernel shape printed
     (Ant's 108 rows through <14, 1, 4, 8>);
  50. reference: 8 envs of each v5 model's state stepped once on the
     card, on the CPU plain path and on it in float64: where the CPU
     float32 path is within 2e-4 of float64 in every env, the card within
     2e-4 of the CPU float32 path in every env, else held to float64 by
     the median env (check_reference);
  51. kernels: B1 and B2 at each new nv (InvertedDoublePendulum 3,
     Reacher 4, Swimmer 5, Hopper 6, HalfCheetah 9, Pusher 11, Humanoid
     23; B1 alone on Ant's 108 rows, `newton_nv14_r128`) on random
     systems, the main path's state and pressed states (limbs past their
     ranges, roots lowered into the floor), held as at nv = 30 (phase
     37), timed, with solve_ex beside the Cholesky;
  52. make_gym on Hopper-v5 (the per-env path's fused Newton at nv = 6),
     InvertedPendulum-v5 (the closed-form nv = 2 route, B6) and
     HalfCheetah-v3: 3 steps each, launches per step counted;
  21. (run after phases 22-52) edge checks of the redesigned kernels
     (topk_select_kernel,
     newton_tile_kernel, chol_tile_kernel, narrowphase_kernel,
     newton2_kernel, fk_kernel) against
     their plain versions on the card: topk_select at (2, 744) -> 8
     (AntMaze_Large's shape) on tied ranks, at B = 1 and B = 2047, at the
     hand's (2, 160) -> 16 at B = 1 and 1023 and with a NaN lane, with K
     larger than the unmasked count, with an all-masked group and a NaN
     lane; the Newton solve at nv = 14, 15, 21, 30, 33 and 36 at the row
     caps of every instantiation (96 and 128 at nv = 14: AntMaze's shape
     and Ant's; 256, 256, 288, 288, 288) and one row under each at B = 1,
     at an ne that is not a multiple of 32, at 72 rows and B = 2047
     (and the hand's 272 rows, Door's 278 and Hammer's 275 at B = 1023),
     with n_iter = 0, with every row inactive and with a strided J (nv =
     24 and 29 at those edges, with HandReach's 272 and the kitchen's 188
     rows, and the locomotion nv at theirs: tests/test_torch_solver.py's
     cuda tests); the Cholesky at nv = 14, 15, 21, 30, 33 and 36 at
     B = 1, 1023 and 2047, with M transposed
     and sliced, envs on the 1e-20 floor and a NaN env; the narrowphase on
     the pressed AntMaze, FetchPush, FetchSlide and AdroitHandDoor states at
     B = 1 and B = 2047 (Door: its 1024), each
     kind alone (bitwise equal to the whole table's rows), with picks out
     of range and int64 picks; and newton2_kernel on both nv = 2 routes on
     the rows of PointMaze_UMaze-v3 (19), PointMaze_Medium-v3 (39) and
     PointMaze_Large-v3 (63) at B = 8192, held to their plain versions in
     float64, timed and bounded; and the FK kernel on the random poses of
     phase 16 at the edges of its launch (B = 1, 33 and 2047, qpos
     batch-leading);
  53. the reference checks of phases 13, 24, 28, 31, 36, 39, 41, 45 and
     50, in that order, each printing its errors, and the seconds the run
     waited on the CPU paths;
  then a JSON line of the kernels (the redesigned kernels' rows, fk and
  the nv = 2 rows included, also carry ptxas' registers and spill bytes,
  the blocks per SM cudaOccupancyMaxActiveBlocksPerMultiprocessor gives,
  the shared memory bytes and the launch geometry, after the wrappers'
  shared memory sizes (and, at nv = 2, lanes an env) are held to the
  sources'; the nv = 2 rows carry their readings by row count as
  ``by_ne``, the determinant route its B = 1 time as ``B1``), the card
  line, and the last line {"ok": true, "device": {...}}. Each phase prints
  its wall time.
"""

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np

B = 8192
STEPS = 320
ANT_B = 2048
ANT_STEPS = 13        # every env resets; kept short for the later phases
ANT_LIMIT = 10        # max_episode_steps cut from 700
ANT_REF_STEPS = 2     # reference steps on the CPU, the first gated
FETCH_B = 2048
FETCH_STEPS = 4
FETCH_LIMIT = 3       # max_episode_steps cut from 50: every env resets
FK_STEPS = 3
FK_LIMIT = 2          # max_episode_steps cut from 50: every env resets
FK_PER_STEP = 22      # 20 substeps' forwards, the gripper refresh, the reset
FK_STEP_SHARE = 0.9   # envs within TOL after one env step, FK kernel vs not
FK_LEVEL_SLACK = 2    # FK kernel path's largest error vs float64 <= 2x level's
FK_REF_ENVS = 64      # envs stepped in float64 on the CPU as the reference
FK_SEEDS = (1,)       # the env-step action's seed (one, to keep the run's time)
FK_BURST = 50         # fk_kernel launches traced back to back
GYM_STEPS = 310       # past PointMaze's 300-step limit
HAND_ID = "HandManipulateBlockRotateXYZ-v1"
HAND_GYM_ID = "HandManipulateBlock_ContinuousTouchSensors-v1"
HAND_B = 1024         # bench.py's rung of the hand
HAND_STEPS = 4
HAND_LIMIT = 3        # max_episode_steps cut from 100: every env resets
HAND_REF_ENVS = 32    # cut from 64 to keep the run's time
HAND_GENTLE = 0.1     # action amplitude of the settled reference
TOL = 2e-4            # relative error, scaled by max(1, |ref|), float32
NEWTON_SLACK = 2      # nv = 21: kernel's error vs float64 <= 2x float32 plain's
# the float32 plain Newton's spread over perturbed inputs (newton_spread):
# copies, and each input's relative perturbation (~8 ulp, the rounding a
# float32 sum over a few hundred rows can leave)
SPREAD_REPS, SPREAD_REL = 8, 1e-6
HBM_BYTES_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
FP32_OPS_S = 67e12     # H100 SXM float32 rate outside the tensor cores
NP_SRC = "gymnasium_robotics_tpu_torch/csrc/narrowphase.cu"
SOLVER_SRC = "gymnasium_robotics_tpu_torch/csrc/solver.cu"
FK_SRC = "gymnasium_robotics_tpu_torch/csrc/kinematics.cu"
# float operations of one pair of each narrowphase group kind by kind
# (plane-sphere, plane-capsule, sphere-box, capsule-box, plane-box,
# box-box, plane-hull at 24 vertices, plane-cylinder, cylinder-box;
# capsule-capsule, capsule-cylinder (24 rounds of two point-cylinder
# distances, 88 a round, then the contact, 148), cylinder-cylinder (two
# such searches), sphere-capsule), counted from the formulas of
# csrc/narrowphase.cu, each slot's frame included; cylinder-hull's and
# capsule-hull's (kinds 9 and 14) two probes cost HULL_PROBE_OPS each plus
# HULL_FACE_OPS a real face of the picked hull (narrow_ops)
NARROW_OPS = {0: 40, 1: 90, 2: 115, 3: 366, 4: 624, 5: 4442, 6: 1104, 7: 133,
              8: 366, 10: 140, 11: 2260, 12: 4485, 13: 100}   # 9, 14: hull faces
HULL_PROBE_OPS, HULL_FACE_OPS = 77, 7
NEW_KINDS = (7, 8, 9)   # plane-cylinder, cylinder-box, cylinder-hull
ADROIT_B = 1024       # bench.py's rung of AdroitHandDoor
ADROIT_STEPS = 6
ADROIT_LIMIT = 5      # max_episode_steps cut from 200: every env resets
ADROIT_REF_ENVS = 8
# capsule-capsule, capsule-cylinder, cylinder-cylinder, sphere-capsule
ADROIT_NEW_KINDS = (10, 11, 12, 13)
# each Adroit task's topk_select shapes: the pair-topk broadphase, the
# contact cap
ADROIT_IDS = {"AdroitHandDoor-v1": ((6, 64, 16), (2, 300, 16)),
              "AdroitHandHammer-v1": ((5, 45, 16), (2, 247, 16)),
              "AdroitHandPen-v1": ((2, 33, 24), (2, 170, 16)),
              "AdroitHandRelocate-v1": ((2, 33, 16), (2, 146, 16))}
FETCH_REF_ENVS = 4
FETCH_REF_WARM = 2    # card steps before the compared one
REACH_ID = "HandReach-v3"
REACH_B = 1024        # the hand's rung
REACH_STEPS = 4
REACH_LIMIT = 3       # max_episode_steps cut from 50: every env resets
REACH_REF_ENVS = 32
KITCHEN_ID = "FrankaKitchen-v1"
KITCHEN_B = 512       # bench.py's rung of FrankaKitchen-v1
KITCHEN_STEPS = 2     # cut from 3 to keep the run's time
KITCHEN_LIMIT = 1     # max_episode_steps cut from 280: every env resets
KITCHEN_REF_ENVS = 8
KITCHEN_NEW_KINDS = (14,)   # capsule-hull
KETTLE_Z = 25               # the kettle's free joint: its height in qpos
LOCO_ID = "HalfCheetah-v5"   # bench.py's rung of the locomotion family
LOCO_B = 8192
LOCO_STEPS = 6
LOCO_LIMIT = 4        # max_episode_steps cut from 1000: every env resets
LOCO_OTHER_STEPS = 3  # the other v5 models, each with the limit cut to 2
LOCO_OTHERS = ("Ant-v5", "Hopper-v5", "Walker2d-v5", "Swimmer-v5",
               "Humanoid-v5", "HumanoidStandup-v5", "InvertedPendulum-v5",
               "InvertedDoublePendulum-v5", "Reacher-v5", "Pusher-v5")
LEGACY_IDS = ("Reacher-v2", "Pusher-v2", "InvertedPendulum-v2",
              "InvertedDoublePendulum-v2", "HalfCheetah-v2", "HalfCheetah-v3",
              "Hopper-v2", "Hopper-v3", "Swimmer-v2", "Swimmer-v3",
              "Walker2d-v2", "Walker2d-v3", "Ant-v2", "Ant-v3", "Humanoid-v2",
              "Humanoid-v3", "HumanoidStandup-v2")
LEGACY_B = 1024
LEGACY_STEPS = 2      # the limit cut to 1: every env resets
LOCO_REF_ENVS = 8
# the new B1/B2 instantiations, each on one model's rows: (id, the Newton
# row's name (None: newton_nv<nv>), whether B2 at its nv is new too)
LOCO_KERNELS = (("InvertedDoublePendulum-v5", None, True),
                ("Reacher-v5", None, True), ("Swimmer-v5", None, True),
                ("Hopper-v5", None, True), ("HalfCheetah-v5", None, True),
                ("Pusher-v5", None, True), ("Ant-v5", "newton_nv14_r128", False),
                ("Humanoid-v5", None, True))
LOCO_GYM_IDS = ("Hopper-v5", "InvertedPendulum-v5", "HalfCheetah-v3")
BIG = 1e9             # contact distances above this: slots far from touching
TRACE_SUBSTEPS = 4    # substeps of a traced step (trace's window)
GYM_STEPS_SHORT = 1   # steps of the single envs of 20 substeps a step (the
                      # hand, HandReach, the Fetch tasks; cut from 3)
REF_WORKERS = 4       # processes stepping the CPU references of phases 13,
                      # 24, 28, 31, 36, 39, 41, 45 and 50 beside the card
GEOMS = ("plane", "hfield", "sphere", "capsule", "ellipsoid", "cylinder",
         "box", "hull")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def rel_err(x, ref):
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / max(1.0, float(ref.abs().max())))


def time_ms(torch, fn, n=50, reps=5, graph=True):
    """Device time of one call of fn: n calls captured in a CUDA graph, so
    the host's launch cost is left out, replayed reps times between CUDA
    events. A call that cannot be captured (graph=False: it waits on the
    host inside) is timed as n * reps calls between CUDA events."""
    if not graph:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n * reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / (n * reps)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (n * reps)


def chol_ops(nv):
    """Floating-point operations of one floored LL^T solve, as the kernel
    does them (sub+mul per product, max+sqrt per pivot, one div each)."""
    fac = sum(2 * i + 2 + (nv - 1 - i) * (2 * i + 1) for i in range(nv))
    return fac + sum(2 * i + 1 for i in range(nv)) + sum(
        2 * (nv - 1 - i) + 1 for i in range(nv))


def newton_ops(nv, ne, n_iter, n_ls):
    """Floating-point operations of the Newton solve for one env, as the
    function defines them (solver_pallas._kernel_nv): per iteration x and
    J p once, and per line-search step x2 = x + alpha J p on every row."""
    nm = nv * (nv + 1) // 2
    mv = nv * (2 * nv - 1)                  # one symmetric product
    dot = 2 * nv - 1
    row = 2 * nv + 4 + 1 + nv + 2 * nv + 2 * nm   # x, Dw, gx, DJ, J^T gx, H
    ls = ne * (2 + 4 + 3 + 3) + 7                  # x2, Dw, s1, s2; alpha
    it = (nv + mv + ne * row + nm + 2 * nv + chol_ops(nv)  # da, Mda, rows, H, g
          + ne * dot + mv + 2 * dot + n_ls * ls + 2 + 2 * nv)
    final = ne * (2 * nv + 4 + 2 + 1 + 2 * nv) + chol_ops(nv) + nv
    return n_iter * it + final


def fk_ops(mt):
    """Floating-point operations of one env's forward kinematics, as
    csrc/kinematics.cu does them: a quaternion rotation 30, a product 28, a
    child frame (rotation, add, product) 61, a normalisation 13, a rotation
    matrix 30; per joint type free 43, ball 137, slide 70, hinge 131 (sine
    and cosine counted as one operation each)."""
    joint = {0: 43, 1: 137, 2: 70, 3: 131}
    return ((mt.nbody - 1) * 61 + sum(joint[t] for t in mt.jnt_type)
            + 13 * sum(1 for i in mt.body_mocapid if i >= 0)
            + mt.nbody * (30 + 61 + 30) + (mt.ngeom + mt.nsite) * (61 + 30))


def fk_bound(mt, nb):
    """Bound of one FK call over nb envs: qpos and the mocap poses read and
    the eleven pose fields written per env (the model's tables, shared by
    every env, once), or fk_ops."""
    out = (mt.nbody * 28 + mt.njnt * 6 + (mt.ngeom + mt.nsite) * 12)
    tables = mt.nbody * 14 + mt.njnt * 6 + mt.nq + (mt.ngeom + mt.nsite) * 7
    ints = mt.nbody * 4 + mt.njnt * 2 + mt.ngeom + mt.nsite
    nbytes = (mt.nq + 7 * mt.nmocap + out) * 4 * nb + (tables + ints) * 4
    return bound(nbytes, fk_ops(mt) * nb)


def newton2_ops(ne, n_iter, n_ls):
    """Floating-point operations of the closed-form nv = 2 Newton solve for
    one env (solver_pallas._kernel): per iteration and row x, the weight,
    the gradient and the three Hessian sums (19) and J p (3); the 2x2 step
    and the quadratic forms (52); per line-search step and row 9, and 7;
    the final forces 12 a row and the M solve 13."""
    it = ne * 22 + 52 + n_ls * (9 * ne + 7)
    return n_iter * it + 12 * ne + 13


def nv2_bound(chol, ne, nb, n_iter, n_ls):
    """Bound of one nv = 2 Newton call over nb envs at ne rows: the lower
    triangle of M, a_smooth, a_warm, J, aref, D and f, qacc as floats;
    active as bytes; is_eq one byte per model row; the operations of the
    Cholesky route (newton_ops) or of the determinant route
    (newton2_ops)."""
    ops = newton_ops(2, ne, n_iter, n_ls) if chol else newton2_ops(ne, n_iter, n_ls)
    return bound((3 + 4 + 2 * ne + 3 * ne + 2) * 4 * nb + ne * nb + ne, ops * nb)


def union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def narrow_ops(m, table, sel, nb):
    """The formulas' operations of one narrowphase call over nb envs
    (NARROW_OPS a pair; a cylinder-hull pair's by the real faces, d above
    -1e9, of the hull each env picked, as this run's picks need)."""
    ops = 0
    for g in table.groups:
        if g.kind in NARROW_OPS:
            ops += NARROW_OPS[g.kind] * g.k * nb
            continue
        faces = (m.hull_face[..., 3] > -1e9).sum(dim=1)          # per hull
        hid = g.hull2[:, None] if g.sel_group < 0 else g.hull2[
            sel[g.sel_group].long().clamp(0, len(g.g2) - 1)]
        ops += int((2 * (HULL_PROBE_OPS + HULL_FACE_OPS * faces[hid])).sum()
                   * (nb if g.sel_group < 0 else 1))
    return ops


def narrow_bound(m, table, sel, n_rows, nb):
    """Bound of one narrowphase call over nb envs: per env the poses (12
    floats) of the geoms that env's pairs reference (every pair of a static
    group, the picked pairs of a pruned one), the int32 picks of the
    table's own pruned groups read, and 13 floats written per kernel row;
    shared by every env and read once, the sizes of the geoms referenced
    and the hull rows the table reads (the static plane-hull hulls'
    vertices, the picked cylinder-hull hulls' real faces, d above -1e9);
    the formulas' operations (narrow_ops)."""
    import torch

    used = torch.zeros((m.meta.ngeom, nb), dtype=torch.bool, device=sel.device)
    envs = torch.arange(nb, device=sel.device)
    n_sel, verts, faces = 0, set(), set()
    for g in table.groups:
        if g.sel_group < 0:
            used[torch.cat([g.g1, g.g2])] = True
            hid = g.hull2
        else:
            pick = sel[g.sel_group].long().clamp(0, len(g.g1) - 1)   # (K, nb)
            used[g.g1[pick], envs] = True
            used[g.g2[pick], envs] = True
            n_sel += pick.numel()
            hid = None if g.hull2 is None else g.hull2[pick]
        if hid is not None:
            (verts if g.kind == 6 else faces).update(hid.unique().tolist())
    shared = (int(used.any(dim=1).sum()) * 3 * m.geom_size.shape[-1]
              + sum(m.hull_vert[h].numel() for h in verts)
              + sum(int((m.hull_face[h, :, 3] > -1e9).sum()) * 4 for h in faces))
    nbytes = ((int(used.sum()) * 12 + n_rows * 13 * nb + shared) * 4
              + n_sel * 4)
    return bound(nbytes, narrow_ops(m, table, sel, nb))


def int64_picks_ms(torch, narrowphase, tp, args, out):
    """ms of a narrowphase call given its picks clamped and widened to
    int64, as a caller that gathers with them holds them: the wrapper's
    conversion back to int32 then runs in the timed graph too."""
    args = args[:4] + (torch.minimum(args[4], tp.sel_max),) + args[5:]
    return time_ms(torch, lambda: narrowphase.narrowphase(*args, out=out))


def kernel_row(name, source, replaces, launches, abs_err, rel, ms, plain_ms,
               bnd, library_ms, shape, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=abs_err, max_rel_err=rel,
                tolerance=TOL, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms,
                shape=shape, **extra)


def zero_counters(solver, narrowphase):
    from gymnasium_robotics_tpu_torch.physics import kinematics

    for c in (solver.LAUNCHES, narrowphase.LAUNCHES, kinematics.LAUNCHES):
        for k in c:
            c[k] = 0
    narrowphase.TOPK_SHAPES.clear()


def launch_counts(solver, narrowphase):
    """Every kernel's launch count: chol, newton, newton_nv2, topk,
    narrowphase and fk."""
    from gymnasium_robotics_tpu_torch.physics import kinematics

    return {**solver.LAUNCHES, **narrowphase.LAUNCHES, **kinematics.LAUNCHES}


def per_step(n, chol=0, newton=0, newton_nv2=0, topk=0, narrowphase=0, fk=0):
    """The launch counts n steps must show, every kernel named."""
    return {"chol": chol * n, "newton": newton * n,
            "newton_nv2": newton_nv2 * n, "topk": topk * n,
            "narrowphase": narrowphase * n, "fk": fk * n}


def set_substeps(env, attr, n):
    """Cut ``env``'s substeps a step (its ``attr``, ``n_substeps`` or
    ``frame_skip``) to n, and its control step ``dt`` (where it has one)
    with them: a whole env step of n substeps."""
    full = getattr(env, attr)
    setattr(env, attr, n)
    if getattr(env, "dt", None) is not None:
        env.dt = env.dt * n / full
    return full


def trace(torch, run, n, card, label, cpu=True, counts=None, window=None):
    """n steps of ``run`` timed on the host clock, then n traced with
    torch.profiler (host operators too unless cpu=False, which keeps a
    trace of ~200k kernels a step quick to read): prints the per-step
    device numbers and the kernels by device time; with ``counts`` (a
    function reading the launch counters) also the launches the wrappers
    counted during the traced run, per step. ``window`` (env, attribute):
    the env's substeps a step (its ``n_substeps`` or ``frame_skip``) cut
    to TRACE_SUBSTEPS while timed and traced, and its control step ``dt``
    (where it has one) with them, so the numbers are those of a whole env step of that many
    substeps, and not comparable with a full step's (a full step of the
    Fetch tasks, the hands and the kitchen holds 0.16-0.57M kernels, which
    take the profiler tens of seconds to minutes to hand over)."""
    from torch.autograd import DeviceType

    if window is not None:
        env, attr = window
        dt = getattr(env, "dt", None)
        full = set_substeps(env, attr, TRACE_SUBSTEPS)
        try:
            return trace(torch, run, n, card,
                         f"{label} ({TRACE_SUBSTEPS}-substep step, of {full})",
                         cpu, counts)
        finally:
            setattr(env, attr, full)
            if dt is not None:
                env.dt = dt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    c0 = counts() if counts else {}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    counted = {k: (v - c0[k]) / n for k, v in counts().items()} if counts else None
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert events, "the trace holds no device time"
    busy_ms = union_us([(e.time_range.start, e.time_range.end)
                        for e in events]) / 1e3
    by_name = {}
    for e in events:
        c = by_name.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    ported = ("chol_solve_kernel", "chol_tile_kernel", "newton2_kernel",
              "newton_tile_kernel", "topk_select_kernel", "narrowphase_kernel",
              "fk_kernel")
    ported_ms = sum(ms for name, (_, ms) in by_name.items()
                    if any(k in name for k in ported))
    print(f"{label}: " + json.dumps({
        "steps": n, "host_ms_per_step": host_ms,
        "traced_ms_per_step": traced_ms / n,
        "device_busy_ms_per_step": busy_ms / n,
        "device_idle_share": 1.0 - busy_ms / traced_ms,
        "kernels_per_step": len(events) / n,
        "ported_kernels_share_of_busy": ported_ms / busy_ms,
        **({"counted_launches_per_step": counted} if counted else {}),
        "card": card}), flush=True)
    for i, (name, (c, ms)) in enumerate(top):
        if i < 15 or any(k in name for k in ported):
            print(f"  {ms / n:9.4f} ms/step {c / n:6.1f}x {name[:110]}")


def check_pair(fn, plain, inputs, outs=None):
    """(max rel err, max abs err) of a kernel's wrapper against its plain
    version over the input sets."""
    rel = ab = 0.0
    for args in inputs:
        got, ref = fn(*args), plain(*args)
        if not isinstance(got, tuple):
            got, ref = (got,), (ref,)
        for g, r in zip(got, ref):
            rel = max(rel, rel_err(g, r))
            ab = max(ab, float((g.double() - r.double()).abs().max()))
    return rel, ab


def pointmaze(torch, dev, card, solver, constraint, narrowphase, convert,
              registry):
    """Phases 3-6; returns the kernels' JSON rows and (model, data) of the
    main path's last state."""
    # --- 3. main path
    env = registry.make("PointMaze_UMaze-v3", num_envs=B)
    obs, info = env.reset(seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(B, dtype=torch.bool, device=dev)
    warm = 20
    zero_counters(solver, narrowphase)
    for i in range(STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((B, 2), generator=gen, device=dev) * 2 - 1
        obs, _, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs["observation"]).all(dim=1)
        was_reset |= terminated | truncated
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts(solver, narrowphase)
    ms_step = wall / (STEPS - warm) * 1e3
    assert obs["observation"].shape == (B, 4), obs["observation"].shape
    assert bool(finite.all()), "non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    assert not bool(info["diverged"].any()), "diverged envs"
    assert launches == per_step(STEPS, chol=2, newton=1), launches
    print(f"main path: PointMaze_UMaze-v3 x{B}, {STEPS} steps, launches "
          f"{launches}; {ms_step:.4f} ms/step, "
          f"{B / ms_step * 1e3:.1f} env-steps/s over steps {warm}-{STEPS} "
          f"[{card}]", flush=True)

    # --- 4. trace of the same env: where the step's time goes
    def run(n):
        for _ in range(n):
            env.step(torch.rand((B, 2), generator=gen, device=dev) * 2 - 1)

    trace(torch, run, 20, card, "trace")

    # --- 5. the card against the CPU plain path from one state
    small = 64
    env_g = registry.make("PointMaze_UMaze-v3", num_envs=small)
    env_c = registry.make("PointMaze_UMaze-v3", num_envs=small, device="cpu")
    env_g.reset(seed=3)
    env_c.reset(seed=3)
    rng = np.random.default_rng(0)
    dirs = rng.uniform(-1, 1, (small, 2))
    for _ in range(20):
        env_g.step(torch.as_tensor(dirs, dtype=torch.float32, device=dev))
    env_c.state = convert.env_state_from_numpy(
        convert.env_state_to_numpy(env_g.state), "cpu")
    ref_err = 0.0
    for _ in range(30):
        a = np.clip(dirs + rng.uniform(-0.3, 0.3, (small, 2)), -1, 1)
        a = a.astype(np.float32)
        og = env_g.step(torch.as_tensor(a, device=dev))[0]["observation"]
        oc = env_c.step(torch.as_tensor(a))[0]["observation"]
        ref_err = max(ref_err, rel_err(og.cpu(), oc))
    assert ref_err <= TOL, f"card vs CPU path: relerr {ref_err:.3e}"
    print(f"reference: card vs CPU plain path, {small} envs x 30 steps, "
          f"relerr {ref_err:.3e}", flush=True)

    # --- 6. kernels against their plain versions
    rs = np.random.RandomState(0)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    # Cholesky: random SPD systems and the main path's own qM
    nv = 2
    A = rs.normal(size=(nv, nv, B))
    M = cuda(np.einsum("ikb,jkb->ijb", A, A) + 0.1 * np.eye(nv)[:, :, None])
    b = cuda(rs.normal(size=(nv, B)))
    d = env.state.data
    chol_err, chol_abs = check_pair(solver.solve_pos, solver.solve_pos_plain,
                                    ((M, b), (d.qM, d.qfrc_smooth)))
    chol_ms = time_ms(torch, lambda: solver.solve_pos(M, b))
    chol_plain_ms = time_ms(torch, lambda: solver.solve_pos_plain(M, b))
    Mb = M.permute(2, 0, 1).contiguous()
    bb = b.T.contiguous()[:, :, None]
    chol_lib_ms = time_ms(torch, lambda: torch.linalg.solve_ex(Mb, bb))
    nm = nv * (nv + 1) // 2
    chol_bound = bound((nm + 2 * nv) * 4 * B, chol_ops(nv) * B)

    # Newton: random systems (mixed is_eq/active) and the main path's rows
    m = env.env.model
    n_iter = min(m.opt.iterations, 20)
    n_ls = min(m.opt.ls_iterations, 8)
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    ne = J.shape[0]
    real = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    wall_rows = torch.tensor([m.meta.geom_type[g] == 6  # box
                              for g in d.contact.geom2.tolist()], device=dev)
    n_touching = int(active[wall_rows].any(dim=0).sum())
    assert n_touching > 0, "no ball touches a wall in the main path's state"
    rand = (
        M, cuda(rs.normal(size=(nv, B))), cuda(rs.normal(size=(nv, B))),
        cuda(rs.normal(size=(ne, nv, B))), cuda(rs.normal(size=(ne, B))),
        cuda(np.exp(rs.normal(size=(ne, B)))),
        cuda(rs.uniform(size=(ne, B)) < 0.7, torch.bool),
        cuda(rs.uniform(size=(ne, B)) < 0.2, torch.bool),
    )
    newton_err, newton_abs = check_pair(
        lambda *a: solver.solve_newton(*a, n_iter=n_iter, n_ls=n_ls),
        lambda *a: solver.solve_newton_plain(*a, n_iter=n_iter, n_ls=n_ls),
        (rand, real))
    newton_ms = time_ms(torch, lambda: solver.solve_newton(
        *real, n_iter=n_iter, n_ls=n_ls))
    newton_plain_ms = time_ms(
        torch, lambda: solver.solve_newton_plain(*real, n_iter=n_iter,
                                                 n_ls=n_ls), n=10)
    newton_bound = nv2_bound(True, ne, B, n_iter, n_ls)
    assert chol_err <= TOL, f"chol_solve: relerr {chol_err:.3e}"
    assert newton_err <= TOL, f"newton: relerr {newton_err:.3e}"
    print(f"kernels: {n_touching} of {B} envs touch a wall in the real rows",
          flush=True)
    return [
        kernel_row("chol_solve", SOLVER_SRC,
                   "gymnasium_robotics_tpu/physics/solver_pallas.py:455",
                   launches["chol"], chol_abs, chol_err, chol_ms,
                   chol_plain_ms, chol_bound, chol_lib_ms, [nv, B]),
        kernel_row("newton", SOLVER_SRC,
                   "gymnasium_robotics_tpu/physics/solver_pallas.py:249",
                   launches["newton"], newton_abs, newton_err, newton_ms,
                   newton_plain_ms, newton_bound, None,
                   [nv, ne, B, n_iter, n_ls]),
    ], (m, d)


def pressed_state(torch, pipeline, m, n, seed, dev):
    """A forwarded AntMaze state of n ants in the top-left cell, torso
    0.5-1.0 from its top or left wall and low, so that the legs press into
    the walls and the floor."""
    rs = np.random.RandomState(seed)
    qpos = np.tile(m.qpos0.cpu().numpy()[:, 0], (n, 1))
    u = rs.uniform(0.5, 1.0, n)
    along = rs.uniform(-5.0, -3.0, n)
    top = np.arange(n) % 2 == 0
    qpos[:, 0] = np.where(top, along, -6.0 + u)
    qpos[:, 1] = np.where(top, 6.0 - u, along + 8.0)
    qpos[:, 2] = rs.uniform(0.25, 0.55, n)
    lo, hi = m.jnt_range.cpu().numpy()[1:, :, 0].T
    qpos[:, 7:] = rs.uniform(lo, hi, (n, len(lo)))
    d = pipeline.make_data(m, n)
    d.qpos[:] = torch.as_tensor(qpos.T, dtype=torch.float32, device=dev)
    d.qvel[:] = torch.as_tensor(rs.normal(0, 0.5, (m.nv, n)),
                                dtype=torch.float32, device=dev)
    return pipeline.forward(m, d)


def tie_ranks(rs, G, maxk, n):
    """Ranks on a coarse grid (many ties), with -inf and +inf entries, a
    mask that cuts group 0 short, and a lane with fewer finite ranks than
    any K."""
    rank = rs.randint(-4, 5, (G, maxk, n)).astype(np.float32) * 0.5
    rank[rs.uniform(size=rank.shape) < 0.03] = -np.inf
    rank[rs.uniform(size=rank.shape) < 0.05] = np.inf
    rank[:, 5:, min(1, n - 1)] = np.inf
    mask = np.ones((G, maxk), bool)
    mask[0, maxk // 3:] = False
    return rank, mask


def antmaze(torch, dev, card, solver, constraint, narrowphase, collision,
            pipeline, convert, registry):
    """Phases 7-10; returns the kernels' JSON rows."""
    # --- 7. main path
    env = registry.make("AntMaze_UMaze-v5", num_envs=ANT_B,
                        max_episode_steps=ANT_LIMIT)
    obs, info = env.reset(seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(ANT_B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(ANT_B, dtype=torch.bool, device=dev)
    diverged = torch.zeros(ANT_B, dtype=torch.bool, device=dev)
    warm = 5
    zero_counters(solver, narrowphase)
    for i in range(ANT_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((ANT_B, 8), generator=gen, device=dev) * 2 - 1
        obs, _, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs["observation"]).all(dim=1)
        was_reset |= terminated | truncated
        diverged |= info["diverged"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts(solver, narrowphase)
    shapes = dict(narrowphase.TOPK_SHAPES)
    ms_step = wall / (ANT_STEPS - warm) * 1e3
    n = ANT_STEPS
    assert obs["observation"].shape == (ANT_B, 105), obs["observation"].shape
    assert bool(finite.all()), "non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    assert launches == per_step(n, chol=20, newton=20, topk=40,
                                narrowphase=20), launches
    assert shapes == {(2, 216, 8): 20 * n, (1, 57, 16): 20 * n}, shapes
    print(f"main path: AntMaze_UMaze-v5 x{ANT_B}, {n} steps, limit "
          f"{ANT_LIMIT}, launches {launches}; {ms_step:.4f} ms/step, "
          f"{ANT_B / ms_step * 1e3:.1f} env-steps/s over steps {warm}-{n}; "
          f"{int(diverged.sum())} envs truncated as diverged [{card}]",
          flush=True)

    # --- 8. trace
    def run(k):
        for _ in range(k):
            env.step(torch.rand((ANT_B, 8), generator=gen, device=dev) * 2 - 1)

    trace(torch, run, 2, card, "ant trace")

    # --- 9. the card against the CPU plain path from one state
    small = 8
    env_g = registry.make("AntMaze_UMaze-v5", num_envs=small)
    env_c = registry.make("AntMaze_UMaze-v5", num_envs=small, device="cpu")
    env_g.reset(seed=3)
    env_c.reset(seed=3)
    rng = np.random.default_rng(0)
    for _ in range(20):   # down onto the floor
        env_g.step(torch.as_tensor(rng.uniform(-1, 1, (small, 8)),
                                   dtype=torch.float32, device=dev))
    env_c.state = convert.env_state_from_numpy(
        convert.env_state_to_numpy(env_g.state), "cpu")
    errs = []
    for _ in range(ANT_REF_STEPS):
        a = rng.uniform(-1, 1, (small, 8)).astype(np.float32)
        og = env_g.step(torch.as_tensor(a, device=dev))[0]
        oc = env_c.step(torch.as_tensor(a))[0]
        errs.append(max(rel_err(og[k].cpu(), oc[k]) for k in oc))
    assert errs[0] <= TOL, f"card vs CPU path after 1 step: relerr {errs[0]:.3e}"
    c = env_c.state.data.contact     # active where dist < includemargin
    n_contact = int((c.dist < env_c.env.model.con_includemargin[:, 0][c.src])
                    .any(dim=0).sum())
    print(f"ant reference: card vs CPU plain path, {small} envs, relerr "
          f"{errs[0]:.3e} after 1 step (gated), per step {errs} "
          f"({ANT_REF_STEPS} steps, not gated); {n_contact} envs in contact",
          flush=True)

    # --- 10. kernels against their plain versions, B = 2048
    m = env.env.model
    rs = np.random.RandomState(0)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    d = pressed_state(torch, pipeline, m, ANT_B, 1, dev)
    d_rand = pressed_state(torch, pipeline, m, ANT_B, 2, dev)
    plan = collision.prune_plan(m.meta)
    cb = next(g for g in plan.groups if g.tp == (3, 6))    # capsule-box
    c = d.contact
    n_press = int((c.dist[cb.base_c:cb.base_c + cb.n_slots_c] < 0)
                  .any(dim=0).sum())
    assert n_press > 0, "no leg presses into a wall in the real state"
    tp = m.plan("pruned", collision._PrunedPlan)
    rp = m.plan("rows", constraint._RowPlan)
    rows = []

    # topk_select at both shapes: forced ties, and the main path's ranks
    pen = c.dist - m.con_includemargin[:, 0][c.src]
    real_topk = {
        (2, 216, 8): (collision.broadphase_rank(m, d, tp), tp.mask),
        (1, 57, 16): (pen[rp.cap_rows], rp.cap_mask),
    }
    rows += topk_rows(torch, narrowphase, rs, cuda, real_topk, shapes, ANT_B)

    # narrowphase: random picks on other poses, and the main path's picks
    # (int32, clamped by the kernel, as collision passes them)
    sel_real = narrowphase.topk_select(collision.broadphase_rank(m, d, tp),
                                       tp.mask, tp.K)
    sel_rand = torch.stack([
        cuda(rs.randint(0, len(g.g1), (tp.K, ANT_B)), torch.int64)
        for g in tp.table.groups if g.sel_group >= 0])
    real_np = (tp.table, d.geom_xpos, d.geom_xmat, m.geom_size, sel_real)
    np_err, np_abs = check_pair(
        narrowphase.narrowphase, narrowphase.narrowphase_plain,
        ((tp.table, d_rand.geom_xpos, d_rand.geom_xmat, m.geom_size, sel_rand),
         real_np))
    out = tuple(torch.empty_like(x) for x in narrowphase.narrowphase(*real_np))
    np_ms = time_ms(torch, lambda: narrowphase.narrowphase(*real_np, out=out))
    np_plain_ms = time_ms(torch, lambda: narrowphase.narrowphase_plain(
        *real_np, out=out), n=10)
    np_bound = narrow_bound(m, tp.table, sel_real, int(tp.table.rows.numel()),
                            ANT_B)
    assert np_err <= TOL, f"narrowphase: relerr {np_err:.3e}"
    rows.append(kernel_row(
        "narrowphase", NP_SRC,
        "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:201",
        launches["narrowphase"], np_abs, np_err, np_ms, np_plain_ms, np_bound,
        None, [tp.ncon, ANT_B],
        ms_int64_picks=int64_picks_ms(torch, narrowphase, tp, real_np, out),
        ms_by_kind=kind_times(torch, narrowphase, tp.table, real_np[1:], out),
        tasks=int(tp.table.tasks.shape[0])))

    # Cholesky at nv = 14: random SPD systems and the real qM
    nv = m.nv
    A = rs.normal(size=(nv, nv, ANT_B))
    M = cuda(np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None])
    b = cuda(rs.normal(size=(nv, ANT_B)))
    chol_err, chol_abs = check_pair(solver.solve_pos, solver.solve_pos_plain,
                                    ((M, b), (d.qM, d.qfrc_smooth)))
    chol_ms = time_ms(torch, lambda: solver.solve_pos(d.qM, d.qfrc_smooth))
    chol_plain_ms = time_ms(torch, lambda: solver.solve_pos_plain(
        d.qM, d.qfrc_smooth), n=10)
    Mb = d.qM.permute(2, 0, 1).contiguous()
    bb = d.qfrc_smooth.T.contiguous()[:, :, None]
    chol_lib_ms = time_ms(torch, lambda: torch.linalg.solve_ex(Mb, bb))
    nm = nv * (nv + 1) // 2
    assert chol_err <= TOL, f"chol_solve nv=14: relerr {chol_err:.3e}"
    f64 = chol_f64_gate(torch, solver, "chol nv=14", {
        "pressed qM": (d.qM, d.qfrc_smooth)})
    rows.append(kernel_row(
        "chol_solve_nv14", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:455",
        launches["chol"], chol_abs, chol_err, chol_ms, chol_plain_ms,
        bound((nm + 2 * nv) * 4 * ANT_B, chol_ops(nv) * ANT_B), chol_lib_ms,
        [nv, ANT_B], f64_rel_err=f64[0], plain32_f64_rel_err=f64[1]))

    # Newton at nv = 14, 72 rows: random rows and the real ones
    n_iter = min(m.opt.iterations, 20)
    n_ls = min(m.opt.ls_iterations, 8)
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    ne = J.shape[0]
    real = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    rand = (M, cuda(rs.normal(size=(nv, ANT_B))),
            cuda(rs.normal(size=(nv, ANT_B))),
            cuda(rs.normal(size=(ne, nv, ANT_B))),
            cuda(rs.normal(size=(ne, ANT_B))),
            cuda(np.exp(rs.normal(size=(ne, ANT_B)))),
            cuda(rs.uniform(size=(ne, ANT_B)) < 0.6, torch.bool), is_eq)
    newton_err, newton_abs = check_pair(
        lambda *a: solver.solve_newton(*a, n_iter=n_iter, n_ls=n_ls),
        lambda *a: solver.solve_newton_plain(*a, n_iter=n_iter, n_ls=n_ls),
        (rand, real))
    newton_ms = time_ms(torch, lambda: solver.solve_newton(
        *real, n_iter=n_iter, n_ls=n_ls))
    newton_plain_ms = time_ms(torch, lambda: solver.solve_newton_plain(
        *real, n_iter=n_iter, n_ls=n_ls), n=5)
    assert newton_err <= TOL, f"newton nv=14: relerr {newton_err:.3e}"
    rows.append(kernel_row(
        "newton_nv14", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:249",
        launches["newton"], newton_abs, newton_err, newton_ms,
        newton_plain_ms,
        bound((nm + 2 * nv + ne * nv + 3 * ne + nv) * 4 * ANT_B
              + ne * ANT_B + ne, newton_ops(nv, ne, n_iter, n_ls) * ANT_B),
        None, [nv, ne, ANT_B, n_iter, n_ls]))
    n_active = int(active.any(dim=0).sum())
    print(f"ant kernels: {n_press} of {ANT_B} envs press a leg into a wall, "
          f"{n_active} have active rows; {ne} rows", flush=True)
    return rows, (m, d, None)


def arm_poses(env, n, seed):
    """(qpos (nq, n), mocap_pos (1, 3, n), mocap_quat (1, 4, n)) of Fetch
    arms pressed into things, cycling through five poses: the object on the
    table pressed 4 mm into the fingers' front; the arm lowered 0.1 into
    the table; the object between the fingers, up against the gripper link;
    the wrist folded back into the forearm; the robot off the table and
    lowered onto the floor, the object on the floor. The mocap body sits
    1-3 cm from the gripper link."""
    rs = np.random.RandomState(seed)
    oq = env._obj_qadr
    qpos = np.tile(env._init_qpos.cpu().numpy(), (n, 1))
    for i in range(n):
        yaw = rs.uniform(-0.3, 0.3)
        qpos[i, oq + 3:oq + 7] = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
        pose = i % 5
        if pose == 0:
            qpos[i, oq:oq + 3] = [1.4215, 0.7486, 0.4244]
        elif pose == 1:
            qpos[i, 2] -= 0.1
        elif pose == 2:
            qpos[i, oq:oq + 3] = [1.362, 0.7486, 0.47]
        elif pose == 3:
            qpos[i, 6:13] += [0.235, 0.835, -0.117, 0.7, 0.029, 0.204, 0.426]
        else:
            qpos[i, 1] += 0.45
            qpos[i, 2] -= 0.422
            qpos[i, oq:oq + 3] = [0.9, 1.3, 0.02]
    mp = env._init_mocap_pos.cpu().numpy()[..., None] + rs.uniform(-0.03, 0.03, (1, 3, n))
    mq = env._init_mocap_quat.cpu().numpy()[..., None] + rs.normal(0, 0.1, (1, 4, n))
    return qpos.T, mp, mq


def newton_vs_f64(torch, solver, args, n_iter, n_ls, kernel=None, plain=None):
    """A Newton kernel (solve_newton unless named) on one input set against
    its plain version run in float64 on the same inputs, beside the float32
    plain version against the same: (kernel's rel err, float32 plain's rel
    err, kernel's abs err against the float32 plain version). The rel errs
    of qacc and of f are each on its own max(1, |ref|), as in check_pair."""
    kernel = kernel or solver.solve_newton
    plain_fn = plain or solver.solve_newton_plain
    x64 = [x.double() if x.is_floating_point() else x for x in args]
    ref = plain_fn(*x64, n_iter=n_iter, n_ls=n_ls)
    got = kernel(*args, n_iter=n_iter, n_ls=n_ls)
    plain = plain_fn(*args, n_iter=n_iter, n_ls=n_ls)
    k_rel = max(rel_err(g, r) for g, r in zip(got, ref))
    p_rel = max(rel_err(q, r) for q, r in zip(plain, ref))
    ab = max(float((g.double() - q.double()).abs().max())
             for g, q in zip(got, plain))
    return k_rel, p_rel, ab


def env_errs(got, ref):
    """Per env, the larger of qacc's and f's relative errors (each on the
    env's own max(1, |ref|)): numpy (B,)."""
    return np.max([((g.double() - r.double()).abs().amax(0)
                    / r.double().abs().amax(0).clamp(min=1.0)).cpu().numpy()
                   for g, r in zip(got, ref)], axis=0)


def newton_env_errs(torch, solver, args, n_iter, n_ls):
    """Per env, the Newton kernel's and the float32 plain version's
    relative errors against the plain version run in float64, and the
    kernel's against the float32 plain version: numpy (3, B)."""
    x64 = [x.double() if x.is_floating_point() else x for x in args]
    ref = solver.solve_newton_plain(*x64, n_iter=n_iter, n_ls=n_ls)
    got = solver.solve_newton(*args, n_iter=n_iter, n_ls=n_ls)
    plain = solver.solve_newton_plain(*args, n_iter=n_iter, n_ls=n_ls)
    return np.stack([env_errs(got, ref), env_errs(plain, ref),
                     env_errs(got, plain)])


def newton_spread(torch, solver, args, envs, n_iter, n_ls, seed):
    """For the envs ``envs`` of a Newton set: the largest relative error
    against the float64 plain version (on the unperturbed inputs) that the
    float32 plain version reaches over SPREAD_REPS copies of the inputs,
    each float input scaled by 1 + SPREAD_REL * U(-1, 1) element by element
    (M symmetrically): how far float32 rounding of the inputs alone moves
    that env's solve. numpy (len(envs),)."""
    idx = torch.as_tensor(envs, device=args[0].device)
    x = [a.index_select(a.dim() - 1, idx) if i < 7 or a.dim() == 2 else a
         for i, a in enumerate(args)]
    ref = solver.solve_newton_plain(
        *[a.double() if a.is_floating_point() else a for a in x],
        n_iter=n_iter, n_ls=n_ls)
    g = torch.Generator(device=args[0].device).manual_seed(seed)
    worst = np.zeros(len(envs))
    for _ in range(SPREAD_REPS):
        y = []
        for i, a in enumerate(x):
            if i < 6:
                u = torch.rand(a.shape, generator=g, device=a.device) * 2 - 1
                if i == 0:
                    u = (u + u.transpose(0, 1)) / 2
                a = a * (1 + SPREAD_REL * u)
            y.append(a)
        e = env_errs(solver.solve_newton_plain(*y, n_iter=n_iter, n_ls=n_ls), ref)
        worst = np.fmax(worst, np.where(np.isfinite(e), e, np.inf))
    return worst


def chol_vs_f64(torch, solver, M, b):
    """The Cholesky kernel on one system against its plain version run in
    float64 on the same inputs, beside the float32 plain version against
    the same: (kernel's rel err, float32 plain's rel err)."""
    ref = solver.solve_pos_plain(M.double(), b.double())
    return (rel_err(solver.solve_pos(M, b), ref),
            rel_err(solver.solve_pos_plain(M, b), ref))


def chol_f64_gate(torch, solver, label, systems):
    """The float64 gate of the Cholesky kernel on fixed inputs (beside the
    float32 one): on each named system within TOL of the plain version run
    in float64, or no further from it than NEWTON_SLACK times the float32
    plain version. Returns (largest kernel rel err, largest float32 plain
    rel err)."""
    errs = {name: chol_vs_f64(torch, solver, *sys_) for name, sys_ in systems.items()}
    print(f"{label} against the float64 plain version: (kernel relerr, "
          f"float32 plain relerr) {errs}", flush=True)
    for name, (k, p) in errs.items():
        assert k <= max(TOL, NEWTON_SLACK * p), (
            f"{label} ({name}): relerr {k:.3e} against float64, the float32 "
            f"plain version's {p:.3e}")
    return (max(k for k, _ in errs.values()), max(p for _, p in errs.values()))


def kind_times(torch, narrowphase, table, args, out):
    """ms of the narrowphase kernel on each group kind's pairs alone (the
    table cut to that kind, GroupTable.only), on the same arrays."""
    times = {}
    for k in sorted({g.kind for g in table.groups}):
        sub = table.only([k])
        name = "-".join(GEOMS[t] for t in narrowphase.KINDS[k])
        times[name] = time_ms(torch, lambda: narrowphase.narrowphase(
            sub, *args, out=out))
    return times


def envs_f64(convert, data, n):
    """The first n envs of a batch-last Data, in float64 on the CPU."""
    def cut(x):
        if x is None:
            return None
        x = np.asarray(x)[:n]
        return x.astype(np.float64) if x.dtype.kind == "f" else x

    f = convert.data_to_numpy(data)
    f = {k: ({c: cut(v) for c, v in f[k].items()} if k == "contact"
             else cut(f[k])) for k in f}
    return convert.data_from_numpy(f, "cpu")


def table_err(got, ref, rows):
    """(max rel err, max abs err) of a contact table's kernel rows: the
    distances on their own scale (a slot far from touching, 1e10, must be so
    in both), positions and frames against their largest entry, NaN-equal."""
    rel = ab = 0.0
    for name, g, r in zip(("dist", "pos", "frame"), got, ref):
        g, r = g[rows].double(), r[rows].double()
        if name == "dist":
            far = r >= BIG
            assert bool(((g >= BIG) == far).all()), "a slot far from touching in one only"
            g, r = g[~far], r[~far]
        else:
            nan = r.isnan()
            assert bool((g.isnan() == nan).all()), f"{name}: NaN rows differ"
            g, r = g[~nan], r[~nan]
        rel = max(rel, rel_err(g, r))
        ab = max(ab, float((g - r).abs().max()))
    return rel, ab


def fetchpush(torch, dev, card, solver, constraint, narrowphase, collision,
              pipeline, convert, registry):
    """Phases 11-14; returns the kernels' JSON rows."""
    # --- 11-12. main path and trace
    env, launches, shapes = fetch_main(
        torch, dev, card, solver, narrowphase, registry, "FetchPush-v4",
        ((3, 85, 8), (2, 169, 24)), 25, traced=True)

    # --- 13. the card against the CPU plain path from one state
    def check(ref):
        assert ref[0] <= TOL, f"card vs CPU path after 1 step: relerr {ref[0]:.3e}"
        print(f"fetch reference: card vs CPU plain path, {FETCH_REF_ENVS} envs, "
              f"relerr {ref[0]:.3e} after 1 step", flush=True)

    fetch_reference(torch, dev, convert, registry, "FetchPush-v4", check)

    # --- 14. kernels against their plain versions, B = 2048
    t_phase = time.perf_counter()
    fenv = env.env
    m = fenv.model
    rs = np.random.RandomState(0)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    d_main = pipeline.forward(m, env.state.data)
    qpos, mp, mq = arm_poses(fenv, FETCH_B, 1)
    d_press = pipeline.make_data(m, FETCH_B)
    d_press.qpos[:] = cuda(qpos)
    d_press.mocap_pos[:] = cuda(mp)
    d_press.mocap_quat[:] = cuda(mq)
    d_press = pipeline.forward(m, d_press)
    tp = m.plan("pruned", collision._PrunedPlan)
    rp = m.plan("rows", constraint._RowPlan)
    table = tp.table
    # envs with a penetrating row, per group of the table: the kernel's
    # groups, then the hull groups run with MPR outside it
    spans = [(GEOMS[narrowphase.KINDS[g.kind][0]] + "-"
              + GEOMS[narrowphase.KINDS[g.kind][1]], g.row_off, g.k * g.S)
             for g in table.groups]
    spans += [(f"{GEOMS[r.tp[0]]}-{GEOMS[r.tp[1]]} (MPR)", r.row0, r.k * r.S)
              for r in tp.runs]
    counts = {f"{name}@{r0}": [int((d.contact.dist[r0:r0 + k] < 0).any(dim=0).sum())
                               for d in (d_main, d_press)]
              for name, r0, k in spans}
    print(f"fetch kernels: envs with a penetrating row per group, (main path, "
          f"pressed state): {counts}", flush=True)
    assert all(sum(c) > 0 for c in counts.values()), "a group never penetrates"
    rows = []

    # topk_select: the broadphase (3, 85) -> 8 and the contact cap
    # (2, 169) -> 24, forced ties and the main path's ranks
    pen = d_main.contact.dist - m.con_includemargin[:, 0][d_main.contact.src]
    real_topk = {
        (3, 85, 8): (collision.broadphase_rank(m, d_main, tp), tp.mask),
        (2, 169, 24): (pen[rp.cap_rows], rp.cap_mask),
    }
    rows += topk_rows(torch, narrowphase, rs, cuda, real_topk, shapes, FETCH_B)

    # narrowphase: the main path's and the pressed state's tables
    np_rel = np_abs = 0.0
    for d in (d_main, d_press):
        sel = narrowphase.topk_select(collision.broadphase_rank(m, d, tp),
                                      tp.mask, tp.K)
        args = (table, d.geom_xpos, d.geom_xmat, m.geom_size, sel, m.hull_vert)
        rel, ab = table_err(narrowphase.narrowphase(*args),
                            narrowphase.narrowphase_plain(*args), table.rows)
        np_rel, np_abs = max(np_rel, rel), max(np_abs, ab)
    out = tuple(torch.empty_like(x) for x in (d_main.contact.dist,
                                              d_main.contact.pos,
                                              d_main.contact.frame))
    sel = narrowphase.topk_select(collision.broadphase_rank(m, d_main, tp),
                                  tp.mask, tp.K)
    args = (table, d_main.geom_xpos, d_main.geom_xmat, m.geom_size, sel,
            m.hull_vert)
    np_ms = time_ms(torch, lambda: narrowphase.narrowphase(*args, out=out))
    np_plain_ms = time_ms(torch, lambda: narrowphase.narrowphase_plain(
        *args, out=out), n=10)
    n_rows = int(table.rows.numel())
    np_bound = narrow_bound(m, table, sel, n_rows, FETCH_B)
    assert np_rel <= TOL, f"narrowphase (fetch): relerr {np_rel:.3e}"
    rows.append(kernel_row(
        "narrowphase_fetch", NP_SRC,
        "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:201",
        launches["narrowphase"], np_abs, np_rel, np_ms, np_plain_ms, np_bound,
        None, [n_rows, FETCH_B],
        ms_int64_picks=int64_picks_ms(torch, narrowphase, tp, args, out),
        ms_by_kind=kind_times(torch, narrowphase, table, args[1:], out),
        tasks=int(table.tasks.shape[0])))

    # Cholesky at nv = 21: random SPD systems, the real qM (the smooth
    # solve) and the Euler's damped system (the velocity solve), the
    # pressed state's qM
    nv = m.nv
    A = rs.normal(size=(nv, nv, FETCH_B))
    M = cuda(np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None])
    b = cuda(rs.normal(size=(nv, FETCH_B)))
    real = (d_main.qM, d_main.qfrc_smooth)
    chol_err, chol_abs = check_pair(
        solver.solve_pos, solver.solve_pos_plain,
        ((M, b), real, pipeline.damped_system(m, d_main),
         (d_press.qM, d_press.qfrc_smooth)))
    chol_ms = time_ms(torch, lambda: solver.solve_pos(*real))
    chol_plain_ms = time_ms(torch, lambda: solver.solve_pos_plain(*real), n=10)
    Mb = d_main.qM.permute(2, 0, 1).contiguous()
    bb = d_main.qfrc_smooth.T.contiguous()[:, :, None]
    # at nv = 21 solve_ex waits on the host inside: not capturable
    chol_lib_ms = time_ms(torch, lambda: torch.linalg.solve_ex(Mb, bb),
                          graph=False)
    nm = nv * (nv + 1) // 2
    assert chol_err <= TOL, f"chol_solve nv=21: relerr {chol_err:.3e}"
    f64 = chol_f64_gate(torch, solver, "chol nv=21", {
        "main qM": real, "main damped system": pipeline.damped_system(m, d_main),
        "pressed qM": (d_press.qM, d_press.qfrc_smooth),
        "pressed damped system": pipeline.damped_system(m, d_press)})
    rows.append(kernel_row(
        "chol_solve_nv21", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:455",
        launches["chol"], chol_abs, chol_err, chol_ms, chol_plain_ms,
        bound((nm + 2 * nv) * 4 * FETCH_B, chol_ops(nv) * FETCH_B),
        chol_lib_ms, [nv, FETCH_B], f64_rel_err=f64[0],
        plain32_f64_rel_err=f64[1]))

    # Newton at nv = 21, 255 rows: random rows, the main path's, the pressed
    n_iter = min(m.opt.iterations, 20)
    n_ls = min(m.opt.ls_iterations, 8)
    sets = []
    for d in (d_main, d_press):
        J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
        sets.append((d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq))
    ne = sets[0][3].shape[0]
    sets.insert(0, (M, cuda(rs.normal(size=(nv, FETCH_B))),
                    cuda(rs.normal(size=(nv, FETCH_B))),
                    cuda(rs.normal(size=(ne, nv, FETCH_B))),
                    cuda(rs.normal(size=(ne, FETCH_B))),
                    cuda(np.exp(rs.normal(size=(ne, FETCH_B)))),
                    cuda(rs.uniform(size=(ne, FETCH_B)) < 0.6, torch.bool),
                    sets[0][7]))
    # The weld and the contacts push the arm against each other: qacc is a
    # small difference of large constraint terms, and float32 rounding
    # alone moves it, in the kernel and in the plain version alike. So on
    # every set the kernel is held to the plain version's float64 answer:
    # within TOL of it, or no further from it than NEWTON_SLACK times the
    # float32 plain version.
    errs = [newton_vs_f64(torch, solver, x, n_iter, n_ls) for x in sets]
    print("fetch newton nv=21 (random, main, pressed) against the float64 "
          "plain version: (kernel relerr, float32 plain relerr, kernel vs "
          f"float32 plain abs err) {errs}", flush=True)
    for name, (k, p, _) in zip(("random", "main", "pressed"), errs):
        assert k <= max(TOL, NEWTON_SLACK * p), (
            f"newton nv=21 ({name}): relerr {k:.3e} against float64, the "
            f"float32 plain version's {p:.3e}")
    newton_rel = max(k for k, _, _ in errs)
    newton_abs = max(a for _, _, a in errs)
    real = sets[1]
    newton_ms = time_ms(torch, lambda: solver.solve_newton(
        *real, n_iter=n_iter, n_ls=n_ls))
    newton_plain_ms = time_ms(torch, lambda: solver.solve_newton_plain(
        *real, n_iter=n_iter, n_ls=n_ls), n=5)
    rows.append(kernel_row(
        "newton_nv21", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:249",
        launches["newton"], newton_abs, newton_rel, newton_ms,
        newton_plain_ms,
        bound((nm + 2 * nv + ne * nv + 3 * ne + nv) * 4 * FETCH_B
              + ne * FETCH_B + ne, newton_ops(nv, ne, n_iter, n_ls) * FETCH_B),
        None, [nv, ne, FETCH_B, n_iter, n_ls],
        plain32_rel_err=max(p for _, p, _ in errs),
        gate="max_rel_err and plain32_rel_err against the plain version in "
             "float64; max_abs_err against it in float32; max_rel_err <= "
             f"max(tolerance, {NEWTON_SLACK} x plain32_rel_err) per set"))
    n_active = [int(s[6].any(dim=0).sum()) for s in sets[1:]]
    print(f"fetch kernels: {ne} rows; envs with active rows (main, pressed) "
          f"{n_active} ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return rows, (m, d_press, m.hull_vert)


def hand_poses(env, n, seed):
    """(qpos (nq, n), qvel (nv, n)) of hands around the block, cycling
    through four poses: the block pressed onto the first and middle
    fingertips, pressed 3 mm into the palm, pushed into the forearm's hull,
    and every hand joint 0.02 past one of its limits with the block on the
    floor; the block yawed by up to 0.3 rad."""
    rs = np.random.RandomState(seed)
    m = env.model
    oq, nh = env._obj_qadr, env._robot_nq
    qpos = np.tile(env._init_qpos.cpu().numpy(), (n, 1))
    lo, hi = m.jnt_range.cpu().numpy()[:nh, :, 0].T
    for i in range(n):
        pose = i % 4
        if pose == 0:
            qpos[i, oq:oq + 3] = [0.967, 0.749, 0.144]
        elif pose == 1:
            qpos[i, oq + 2] = 0.165
        elif pose == 2:
            qpos[i, oq:oq + 3] = [1.0, 1.008, 0.13]
        else:
            qpos[i, :nh] = np.where(rs.rand(nh) < 0.5, lo - 0.02, hi + 0.02)
            qpos[i, oq + 2] = 0.02
        yaw = rs.uniform(-0.3, 0.3)
        qpos[i, oq + 3:oq + 7] = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
    return qpos.T, rs.normal(0, 0.05, (m.nv, n))


def cast_state(state, dtype):
    """An EnvState's floating leaves (the Data's, contacts included, and the
    env-level ones) in ``dtype``."""
    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        return x.to(dtype) if x is not None and x.is_floating_point() else x

    d = state.data
    data = dataclasses.replace(d, **{
        f.name: cast(getattr(d, f.name)) for f in dataclasses.fields(d)
        if f.name != "contact"}, contact=dataclasses.replace(d.contact, **{
            k: cast(getattr(d.contact, k)) for k in ("dist", "pos", "frame")}))
    return dataclasses.replace(
        state, data=data, obs=cast(state.obs), reward=cast(state.reward),
        info=cast(state.info), goal=cast(state.goal), aux=cast(state.aux))


class CpuRefs:
    """The CPU references' env steps, run in REF_WORKERS spawned processes
    (one torch thread each) while the card's phases go on, and the checks
    that read them, run at the end (phase 53, ``run``) in the order they
    were made."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing

        self.pool = concurrent.futures.ProcessPoolExecutor(
            REF_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=one_thread)
        self.checks = []

    def step(self, id_, dtype, fields, a, values=None):
        """A future of cpu_step's arrays."""
        return self.pool.submit(cpu_step, id_, dtype, fields, a, values)

    def defer(self, check):
        self.checks.append(check)

    def run(self):
        t0 = time.perf_counter()
        for check in self.checks:
            check()
        print(f"reference checks: {len(self.checks)}, "
              f"{time.perf_counter() - t0:.1f} s waiting on the CPU paths",
              flush=True)

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


CPU_REFS = []   # the run's CpuRefs, made in main


def one_thread():
    import torch

    torch.set_num_threads(1)


def step_fields(torch, convert, e, fields, a, values=None):
    """One step of the batched env ``e`` from ``fields`` (env_state_to_numpy's
    arrays of its envs, float64) with the actions ``a`` (numpy); with
    ``values`` (the kitchen's observation noise, host-drawn: each device's
    generator would draw other noise) through step_with_values. Returns the
    observation's arrays (keyed "obs" or by the observation's keys) and the
    sensordata, (n, .) float64 numpy, and the task mask (None without
    ``values``)."""
    where, dtype = e.env.device, e.env.dtype
    e.state = cast_state(convert.env_state_from_numpy(fields, where), dtype)
    e.generator = torch.Generator(device=where).manual_seed(3)
    a_t = torch.as_tensor(a, dtype=dtype, device=where)
    mask = None
    if values is None:
        o = e.step(a_t)[0]
    else:
        e.state = e.env.step_with_values(e.state, a_t, values)
        o = {"observation": e.state.obs["observation"]}
        mask = e.state.info["tasks_to_complete"].cpu().numpy()
    out = {k: v.double().cpu().numpy() for k, v in (
        o.items() if isinstance(o, dict) else (("obs", o),))}
    sd = e.state.data.sensordata.double().cpu().T
    if sd.numel():
        out["sensordata"] = sd.numpy()
    return out, mask


def cpu_step(id_, dtype, fields, a, values=None):
    """step_fields on the CPU plain path in ``dtype`` ("float32" or
    "float64"), on len(a) fresh envs of ``id_``: CpuRefs' worker."""
    import torch

    from gymnasium_robotics_tpu_torch import convert, registry

    e = registry.make(id_, num_envs=len(a), device="cpu",
                      dtype=getattr(torch, dtype))
    return step_fields(torch, convert, e, fields, a, values)


def env_reference(torch, dev, convert, registry, id_, state, amp, n,
                  values=None):
    """n envs of ``state`` (an ``id_`` batch) stepped once with the same
    seeded actions of amplitude ``amp`` on the card, and, in CpuRefs'
    processes, on the CPU plain path and on it in float64 (step_fields).
    Returns a function that waits for the CPU steps and gives per env the
    largest relative error over the observation and sensordata of (card vs
    CPU float32, card vs CPU float64, CPU float32 vs CPU float64), numpy
    (3, n); the task masks must agree."""

    def cut(x):          # the first envs of B-leading leaves, in float64
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if x is None:
            return None
        x = np.asarray(x)[:n]
        return x.astype(np.float64) if x.dtype.kind == "f" else x

    fields = cut(convert.env_state_to_numpy(state))
    e = registry.make(id_, num_envs=n, device=dev)
    a = np.random.default_rng(0).uniform(-amp, amp, (n, e.env.action_dim))
    cpu = [CPU_REFS[0].step(id_, dtype, fields, a, values)
           for dtype in ("float32", "float64")]
    card = step_fields(torch, convert, e, fields, a, values)

    def per_env(x, y):   # (n,): each env's largest error over the fields
        return np.max([np.abs(x[k] - y[k]).max(1)
                       / np.maximum(np.abs(y[k]).max(1), 1.0) for k in y], axis=0)

    def errors():
        c32, c64 = (f.result() for f in cpu)
        if values is not None:
            assert all(np.array_equal(card[1], k[1]) for k in (c32, c64)), (
                "task masks differ")
        return np.stack([per_env(card[0], c32[0]), per_env(card[0], c64[0]),
                         per_env(c32[0], c64[0])])

    return errors


def check_reference(label, readings, n, strict=()):
    """Each state's per-env errors (env_reference's, waited for) summarised
    and printed; the card is held to the CPU path in float64: its median
    env within TOL of it, or no further than NEWTON_SLACK times the CPU
    float32 path's median env (the float32 solves of the hands are
    ill-conditioned: tendon rows at their limits). The states named in
    ``strict`` (well-conditioned ones) are instead held to the CPU float32
    path within TOL in every env."""
    stats = {
        key: {name: {"median": float(np.median(e)), "p90": float(np.quantile(e, 0.9)),
                     "max": float(e.max()), "within_tol": float((e <= TOL).mean())}
              for name, e in zip(("card_vs_cpu32", "card_vs_cpu64",
                                  "cpu32_vs_cpu64"), errs)}
        for key, errs in readings.items()}
    print(f"{label} reference: {n} envs, 1 env step, per-env relerr over the "
          f"observation and sensordata: {json.dumps(stats)}", flush=True)
    for key, r in stats.items():
        if key in strict:
            assert r["card_vs_cpu32"]["max"] <= TOL, (
                f"{label} reference ({key}): an env {r['card_vs_cpu32']['max']:.3e}"
                " from the CPU float32 path")
            continue
        card, cpu = r["card_vs_cpu64"]["median"], r["cpu32_vs_cpu64"]["median"]
        assert card <= max(TOL, NEWTON_SLACK * cpu), (
            f"{label} reference ({key}): the card's median env {card:.3e} from "
            f"the CPU float64 path, the CPU float32 path's {cpu:.3e}")


def reference_gate(label, pending, n, strict=()):
    """Phases 24, 36, 39, 41 and 45: check_reference on env_reference's
    errors, at the end of the run (CpuRefs)."""
    CPU_REFS[0].defer(lambda: check_reference(
        label, {k: errors() for k, errors in pending.items()}, n, strict))


def handmanipulate(torch, dev, card, solver, constraint, narrowphase,
                   pipeline, convert, registry):
    """Phases 22-26; returns the kernels' JSON rows and the pressed state
    (model, data) for the edge checks."""
    t_phase = time.perf_counter()
    # --- 22. main path
    env = registry.make(HAND_ID, num_envs=HAND_B, max_episode_steps=HAND_LIMIT)
    t0 = time.perf_counter()
    obs, info = env.reset(seed=0)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    hm = env.env
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(HAND_B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(HAND_B, dtype=torch.bool, device=dev)
    diverged = torch.zeros(HAND_B, dtype=torch.bool, device=dev)
    warm = 1
    zero_counters(solver, narrowphase)
    for i in range(HAND_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((HAND_B, 20), generator=gen, device=dev) * 2 - 1
        obs, _, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs["observation"]).all(dim=1)
        was_reset |= terminated | truncated
        diverged |= info["diverged"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts(solver, narrowphase)
    shapes = dict(narrowphase.TOPK_SHAPES)
    ms_step = wall / (HAND_STEPS - warm) * 1e3
    n = HAND_STEPS
    assert obs["observation"].shape == (HAND_B, 61), obs["observation"].shape
    assert bool(finite.all()), "non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    # a substep: the smooth solve and the Euler's damped velocity solve (2
    # chol), the Newton solve, the contact_cap pick of both condim groups
    assert launches == per_step(n, chol=40, newton=20, topk=20), launches
    assert shapes == {(2, 160, 16): 20 * n}, shapes
    print(f"main path: {HAND_ID} x{HAND_B}, {n} steps, limit {HAND_LIMIT}, "
          f"launches {launches}; {ms_step:.4f} ms/step, "
          f"{HAND_B / ms_step * 1e3:.1f} env-steps/s over steps {warm}-{n}; "
          f"initial settle (pool {hm.reset_pool_size} x {HAND_B} envs, 200 "
          f"substeps) {settle_s:.2f} s; {int(diverged.sum())} envs truncated "
          f"as diverged [{card}] ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # --- 23. trace
    t_phase = time.perf_counter()

    def run(k):
        for _ in range(k):
            env.step(torch.rand((HAND_B, 20), generator=gen, device=dev) * 2 - 1)

    trace(torch, run, 1, card, "hand trace", cpu=False,
          counts=lambda: launch_counts(solver, narrowphase),
          window=(hm, "n_substeps"))
    print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 24. the card against the CPU plain path from one state
    # the main path's state with full-range actions, then settled hands
    # (fresh resets from the pool) with small actions
    reference_gate("hand", {
        label: env_reference(torch, dev, convert, registry, HAND_ID, state,
                             amp, HAND_REF_ENVS)
        for label, state, amp in (
            ("main", env.state, 1.0),
            ("settled", hm.reset(env.state, gen), HAND_GENTLE))},
        HAND_REF_ENVS)

    # --- 25. kernels against their plain versions on the main path's arrays
    t_phase = time.perf_counter()
    m = hm.model
    rs = np.random.RandomState(0)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    d_main = pipeline.forward(m, env.state.data)
    qpos, qvel = hand_poses(hm, HAND_B, 1)
    d_press = pipeline.make_data(m, HAND_B)
    d_press.qpos[:] = cuda(qpos)
    d_press.qvel[:] = cuda(qvel)
    d_press = pipeline.forward(m, d_press)
    rp = m.plan("rows", constraint._RowPlan)
    n_pen = [int((d.contact.dist < 0).any(dim=0).sum()) for d in (d_main, d_press)]
    print(f"hand kernels: envs with a penetrating slot (main path, pressed "
          f"state) {n_pen}", flush=True)
    rows = []

    # topk_select: the contact cap (2, 160) -> 16, forced ties and the main
    # path's and the pressed state's depths
    G, maxk, K = 2, 160, 16
    reals = []
    for d in (d_main, d_press):
        pen = d.contact.dist - m.con_includemargin     # the unpruned table
        reals.append(pen[rp.cap_rows])
    r_rand, m_rand = tie_ranks(rs, G, maxk, HAND_B)
    for r, mk in [(cuda(r_rand), cuda(m_rand, torch.bool))] + [
            (x, rp.cap_mask) for x in reals]:
        got = narrowphase.topk_select(r, mk, K)
        assert torch.equal(got, narrowphase.topk_select_plain(r, mk, K)), \
            f"topk_select {(G, maxk, K)} indices differ"
    rank, mask = reals[0], rp.cap_mask
    ms = time_ms(torch, lambda: narrowphase.topk_select(rank, mask, K))
    plain_ms = time_ms(torch, lambda: narrowphase.topk_select_plain(
        rank, mask, K), n=10)
    masked = torch.where(mask[:, :, None], rank, float("inf"))
    lib_ms = time_ms(torch, lambda: torch.topk(masked, K, dim=1, largest=False))
    bnd = bound(G * maxk * HAND_B * 4 + G * maxk + G * K * HAND_B * 4,
                G * maxk * HAND_B)
    rows.append(kernel_row(
        f"topk_select_{G}x{maxk}_k{K}", NP_SRC,
        "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:155",
        shapes[(G, maxk, K)], 0.0, 0.0, ms, plain_ms, bnd, lib_ms,
        [G, maxk, HAND_B, K]))

    # Cholesky at nv = 36: random SPD systems, the real qM (the smooth
    # solve), the Euler's damped system, the pressed state's qM
    nv = m.nv
    A = rs.normal(size=(nv, nv, HAND_B))
    M = cuda(np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None])
    b = cuda(rs.normal(size=(nv, HAND_B)))
    real = (d_main.qM, d_main.qfrc_smooth)
    systems = {"main qM": real,
               "main damped system": pipeline.damped_system(m, d_main),
               "pressed qM": (d_press.qM, d_press.qfrc_smooth),
               "pressed damped system": pipeline.damped_system(m, d_press)}
    rand_err, _ = check_pair(solver.solve_pos, solver.solve_pos_plain, [(M, b)])
    assert rand_err <= TOL, f"chol_solve nv=36 (random): relerr {rand_err:.3e}"
    # the hand's own systems are ill-conditioned in float32: held to the
    # float64 plain version below, as at nv = 21
    chol_err, chol_abs = check_pair(solver.solve_pos, solver.solve_pos_plain,
                                    [(M, b)] + list(systems.values()))
    chol_ms = time_ms(torch, lambda: solver.solve_pos(*real))
    chol_plain_ms = time_ms(torch, lambda: solver.solve_pos_plain(*real), n=10)
    Mb = d_main.qM.permute(2, 0, 1).contiguous()
    bb = d_main.qfrc_smooth.T.contiguous()[:, :, None]
    chol_lib_ms = time_ms(torch, lambda: torch.linalg.solve_ex(Mb, bb),
                          graph=False)
    nm = nv * (nv + 1) // 2
    f64 = chol_f64_gate(torch, solver, "chol nv=36", systems)
    rows.append(kernel_row(
        "chol_solve_nv36", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:455",
        launches["chol"], chol_abs, chol_err, chol_ms, chol_plain_ms,
        bound((nm + 2 * nv) * 4 * HAND_B, chol_ops(nv) * HAND_B),
        chol_lib_ms, [nv, HAND_B], f64_rel_err=f64[0],
        plain32_f64_rel_err=f64[1]))

    # Newton at nv = 36, 272 rows: random rows, the main path's, the pressed
    n_iter = min(m.opt.iterations, 20)
    n_ls = min(m.opt.ls_iterations, 8)
    sets = []
    for d in (d_main, d_press):
        J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
        sets.append((d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq))
    ne = sets[0][3].shape[0]
    sets.insert(0, (M, cuda(rs.normal(size=(nv, HAND_B))),
                    cuda(rs.normal(size=(nv, HAND_B))),
                    cuda(rs.normal(size=(ne, nv, HAND_B))),
                    cuda(rs.normal(size=(ne, HAND_B))),
                    cuda(np.exp(rs.normal(size=(ne, HAND_B)))),
                    cuda(rs.uniform(size=(ne, HAND_B)) < 0.4, torch.bool),
                    sets[0][7]))
    # float32 rounding alone moves the hand's solve far (its coupling
    # tendons' rows sit at their limits; the pressed state's forces reach
    # 1e9): in a few envs of a batch the float32 answers, kernel's and plain
    # version's alike, land anywhere. So the kernel is held to the plain
    # version's float64 answer env by env: its median env within TOL of it,
    # or no further from it than NEWTON_SLACK times the float32 plain
    # version's median env (the batch's largest errors are printed)
    stats = {}
    for name, x in zip(("random", "main", "pressed"), sets):
        e = newton_env_errs(torch, solver, x, n_iter, n_ls)
        stats[name] = {"kernel_median": float(np.median(e[0])),
                       "plain32_median": float(np.median(e[1])),
                       "kernel_max": float(e[0].max()),
                       "plain32_max": float(e[1].max())}
    print("hand newton nv=36 against the float64 plain version, per-env "
          f"relerr: {json.dumps(stats)}", flush=True)
    for name, st in stats.items():
        assert st["kernel_median"] <= max(TOL, NEWTON_SLACK * st["plain32_median"]), (
            f"newton nv=36 ({name}): median env relerr {st['kernel_median']:.3e} "
            f"against float64, the float32 plain version's "
            f"{st['plain32_median']:.3e}")
    _, _, newton_abs = newton_vs_f64(torch, solver, sets[0], n_iter, n_ls)
    real = sets[1]
    newton_ms = time_ms(torch, lambda: solver.solve_newton(
        *real, n_iter=n_iter, n_ls=n_ls))
    newton_plain_ms = time_ms(torch, lambda: solver.solve_newton_plain(
        *real, n_iter=n_iter, n_ls=n_ls), n=3)
    rows.append(kernel_row(
        "newton_nv36", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:249",
        launches["newton"], newton_abs,
        max(st["kernel_median"] for st in stats.values()), newton_ms,
        newton_plain_ms,
        bound((nm + 2 * nv + ne * nv + 3 * ne + nv) * 4 * HAND_B
              + ne * HAND_B + ne, newton_ops(nv, ne, n_iter, n_ls) * HAND_B),
        None, [nv, ne, HAND_B, n_iter, n_ls],
        plain32_rel_err=max(st["plain32_median"] for st in stats.values()),
        by_set=stats,
        gate="max_rel_err and plain32_rel_err: the largest over the sets of "
             "the median env's relerr against the plain version in float64; "
             "max_abs_err against the float32 plain version on the random "
             "set; per set the kernel's median <= max(tolerance, "
             f"{NEWTON_SLACK} x the float32 plain version's)"))
    n_active = [int(s[6].any(dim=0).sum()) for s in sets[1:]]
    print(f"hand kernels: {ne} rows; envs with active rows (main, pressed) "
          f"{n_active} ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 26. the single env: make_gym with touch sensors, parity reset
    t_phase = time.perf_counter()
    genv = registry.make_gym(HAND_GYM_ID, parity=True)
    genv.reset(seed=1)
    zero_counters(solver, narrowphase)
    grng = np.random.default_rng(2)
    touch = 0.0
    for _ in range(GYM_STEPS_SHORT):
        obs = genv.step(grng.uniform(-1, 1, 20))[0]
        assert obs["observation"].shape == (61 + 92,), obs["observation"].shape
        assert all(np.isfinite(v).all() for v in obs.values()), HAND_GYM_ID
        touch = max(touch, float(obs["observation"][61:].max()))
    torch.cuda.synchronize()
    launches = launch_counts(solver, narrowphase)
    assert launches == per_step(GYM_STEPS_SHORT, chol=40, newton=20,
                                topk=20), launches
    print(f"single env {HAND_GYM_ID}: parity reset, {GYM_STEPS_SHORT} "
          f"steps, launches {launches}; largest touch reading {touch:.4f} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return rows, (m, d_press)



def slide_poses(env, n, seed):
    """(qpos (nq, n), qvel (nv, n)) of FetchSlide pucks touching things,
    cycling through five poses, each jittered by up to 2 mm: upright on the
    table 4 mm up into the gripper link; tipped 0.3 rad onto the floor;
    upright on the floor (the axis along the plane's normal: the fallback
    rim point and a NaN tangent); tipped 1.2 rad against the fingers and
    the gripper link; at a random orientation 1-4 mm into the gripper
    link's side."""
    rs = np.random.RandomState(seed)
    oq = env._obj_qadr
    qpos = np.tile(env._init_qpos.cpu().numpy(), (n, 1))
    poses = [[1.06, 0.7497, 0.4445, 1.0, 0.0, 0.0, 0.0],
             [1.7, 1.4, 0.026, np.cos(0.15), np.sin(0.15), 0.0, 0.0],
             [1.7, 1.4, 0.0195, 1.0, 0.0, 0.0, 0.0],
             [1.05, 0.7497, 0.455, np.cos(0.6), 0.0, np.sin(0.6), 0.0]]
    for i in range(n):
        if i % 5 < 4:
            qpos[i, oq:oq + 7] = poses[i % 5]
        else:
            q = rs.normal(size=4)
            qpos[i, oq:oq + 7] = [1.0, 0.7497 + rs.uniform(-0.03, 0.03),
                                  0.49 + rs.uniform(-0.01, 0.01),
                                  *(q / np.linalg.norm(q))]
        qpos[i, oq:oq + 2] += rs.uniform(-0.002, 0.002, 2)
    qvel = np.zeros((n, env.model.nv))
    qvel[:, -6:] = rs.normal(0, 0.05, (n, 6))
    return qpos.T, qvel.T


def fetch_reference(torch, dev, convert, registry, id_, check):
    """Phases 13, 28 and 31: FETCH_REF_ENVS envs of ``id_`` stepped on the
    card for FETCH_REF_WARM steps from a seeded reset, then once more on
    the card and, from the carried state, in CpuRefs' processes on the CPU
    plain path in float32 and float64; at the end of the run ``check`` is
    given (card vs CPU float32 relerr; when that exceeds TOL, card vs CPU
    float64 and CPU float32 vs CPU float64, else None), each the largest
    over the envs and the observation."""
    n = FETCH_REF_ENVS
    env_g = registry.make(id_, num_envs=n)
    env_g.reset(seed=3)
    rng = np.random.default_rng(0)
    for _ in range(FETCH_REF_WARM):
        env_g.step(torch.as_tensor(rng.uniform(-1, 1, (n, 4)),
                                   dtype=torch.float32, device=dev))
    fields = convert.env_state_to_numpy(env_g.state)
    a = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    cpu = [CPU_REFS[0].step(id_, dtype, fields, a)
           for dtype in ("float32", "float64")]
    og = {k: v.double().cpu().numpy()
          for k, v in env_g.step(torch.as_tensor(a, device=dev))[0].items()}

    def err(x, ref):
        return max(float(np.abs(x[k] - ref[k]).max()
                         / max(1.0, float(np.abs(ref[k]).max()))) for k in og)

    def errors():
        (o32, _), (o64, _) = (f.result() for f in cpu)
        err32 = err(og, o32)
        if err32 <= TOL:
            return err32, None, None
        return err32, err(og, o64), err(o32, o64)

    CPU_REFS[0].defer(lambda: check(errors()))


def fetch_main(torch, dev, card, solver, narrowphase, registry, id_, shapes,
               width, traced):
    """Phases 11, 27 and 30: ``id_`` x FETCH_B on the main path (limit
    FETCH_LIMIT, FETCH_STEPS steps, every env auto-resets; per step 40
    chol, 20 Newton, 40 topk_select (20 of each of ``shapes``) and 20
    narrowphase launches), then, if ``traced``, a 1-step trace (phase 12). Returns the env, the launches and the topk_select shapes counted."""
    t_phase = time.perf_counter()
    env = registry.make(id_, num_envs=FETCH_B, max_episode_steps=FETCH_LIMIT)
    env.reset(seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(FETCH_B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(FETCH_B, dtype=torch.bool, device=dev)
    diverged = torch.zeros(FETCH_B, dtype=torch.bool, device=dev)
    warm = 2
    zero_counters(solver, narrowphase)
    for i in range(FETCH_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((FETCH_B, 4), generator=gen, device=dev) * 2 - 1
        obs, _, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs["observation"]).all(dim=1)
        was_reset |= terminated | truncated
        diverged |= info["diverged"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts(solver, narrowphase)
    counted = dict(narrowphase.TOPK_SHAPES)
    ms_step = wall / (FETCH_STEPS - warm) * 1e3
    n = FETCH_STEPS
    assert obs["observation"].shape == (FETCH_B, width), obs["observation"].shape
    assert bool(finite.all()), f"{id_}: non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    assert launches == per_step(n, chol=40, newton=20, topk=40,
                                narrowphase=20), launches
    assert counted == {s: 20 * n for s in shapes}, counted
    print(f"main path: {id_} x{FETCH_B}, {n} steps, limit {FETCH_LIMIT}, "
          f"launches {launches}, topk_select shapes {counted}; {ms_step:.4f} "
          f"ms/step, {FETCH_B / ms_step * 1e3:.1f} env-steps/s over steps "
          f"{warm}-{n}; {int(diverged.sum())} envs truncated as diverged "
          f"[{card}] ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    if not traced:
        return env, launches, counted
    t_phase = time.perf_counter()

    def run(k):
        for _ in range(k):
            env.step(torch.rand((FETCH_B, 4), generator=gen, device=dev) * 2 - 1)

    trace(torch, run, 1, card, f"{id_} trace", cpu=False,
          counts=lambda: launch_counts(solver, narrowphase),
          window=(env.env, "n_substeps"))
    print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return env, launches, counted


def topk_rows(torch, narrowphase, rs, cuda, reals, shapes, nb):
    """topk_select at each shape of ``reals`` ({(G, maxk, K): (rank,
    mask)}, nb envs): indices equal to the plain version's on forced ties
    and on the given ranks; the JSON rows with the kernel's, the plain
    version's and torch.topk's times and the bound (ranks and mask read,
    indices written; one comparison an entry at least), the launches from
    ``shapes``."""
    rows = []
    for (G, maxk, K), (rank, mask) in reals.items():
        r_rand, m_rand = tie_ranks(rs, G, maxk, nb)
        for r, mk in ((cuda(r_rand), cuda(m_rand, torch.bool)), (rank, mask)):
            got = narrowphase.topk_select(r, mk, K)
            assert torch.equal(got, narrowphase.topk_select_plain(r, mk, K)), \
                f"topk_select {(G, maxk, K)} indices differ"
        ms = time_ms(torch, lambda: narrowphase.topk_select(rank, mask, K))
        plain_ms = time_ms(torch, lambda: narrowphase.topk_select_plain(
            rank, mask, K), n=10)
        masked = torch.where(mask[:, :, None], rank, float("inf"))
        lib_ms = time_ms(torch, lambda: torch.topk(masked, K, dim=1,
                                                   largest=False))
        bnd = bound(G * maxk * nb * 4 + G * maxk + G * K * nb * 4,
                    G * maxk * nb)
        rows.append(kernel_row(
            f"topk_select_{G}x{maxk}_k{K}", NP_SRC,
            "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:155",
            shapes[(G, maxk, K)], 0.0, 0.0, ms, plain_ms, bnd, lib_ms,
            [G, maxk, nb, K]))
    return rows


def fetch_slice(torch, dev, card, solver, constraint, narrowphase, collision,
                pipeline, convert, registry):
    """Phases 27-32 (FetchSlide-v4 and FetchReach-v4); returns the kernels'
    JSON rows, FetchSlide's pressed state (model, data) for the edge
    checks, and the narrowphase rows' group tables by row name."""
    rows, tables = [], {}
    # --- 27. FetchSlide main path and trace
    env, launches, shapes = fetch_main(
        torch, dev, card, solver, narrowphase, registry, "FetchSlide-v4",
        ((4, 85, 8), (2, 177, 24)), 25, traced=True)

    # --- 28. the card against the CPU plain path from one state
    # as FetchPush's: within TOL of the CPU float32 path; where the state
    # squeezes a puck between the welded gripper and the table, float32
    # rounding alone moves the solve, and the card is held to the CPU
    # float64 path instead, no further from it than NEWTON_SLACK times the
    # CPU float32 path
    def check(ref):
        assert ref[0] <= TOL or ref[1] <= max(TOL, NEWTON_SLACK * ref[2]), (
            f"FetchSlide card vs CPU path after 1 step: {ref}")
        print(f"slide reference: card vs CPU plain path, {FETCH_REF_ENVS} envs, "
              f"relerr after 1 step (card vs CPU float32, card vs CPU float64, "
              f"CPU float32 vs float64; the last two only where the first "
              f"exceeds {TOL}) {ref}", flush=True)

    fetch_reference(torch, dev, convert, registry, "FetchSlide-v4", check)

    # --- 29. FetchSlide's kernels: B4's new kinds and topk_select
    t_phase = time.perf_counter()
    fenv = env.env
    m = fenv.model
    rs = np.random.RandomState(0)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    d_main = pipeline.forward(m, env.state.data)
    qpos, qvel = slide_poses(fenv, FETCH_B, 1)
    d_press = pipeline.make_data(m, FETCH_B)
    d_press.qpos[:] = cuda(qpos)
    d_press.qvel[:] = cuda(qvel)
    d_press = pipeline.forward(m, d_press)
    slide_ctx = (m, d_press, m.hull_vert)
    tp = m.plan("pruned", collision._PrunedPlan)
    rp = m.plan("rows", constraint._RowPlan)
    table = tp.table
    new = {k: "-".join(GEOMS[t] for t in narrowphase.KINDS[k])
           for k in NEW_KINDS}
    counts = {}   # per new kind, the envs with a penetrating row
    for name in new.values():
        rows_k = [r for g in table.groups if new.get(g.kind) == name
                  for r in range(g.row_off, g.row_off + g.k * g.S)]
        counts[name] = [int((d.contact.dist[rows_k] < 0).any(dim=0).sum())
                        for d in (d_main, d_press)]
    print(f"slide kernels: envs with a penetrating row per new kind (main "
          f"path, pressed state): {counts}", flush=True)
    assert all(c[1] > 0 for c in counts.values()), "a new kind never penetrates"
    pen = d_main.contact.dist - m.con_includemargin[:, 0][d_main.contact.src]
    rows += topk_rows(torch, narrowphase, rs, cuda, {
        (4, 85, 8): (collision.broadphase_rank(m, d_main, tp), tp.mask),
        (2, 177, 24): (pen[rp.cap_rows], rp.cap_mask)}, shapes, FETCH_B)
    # the whole table and each new kind alone, on the main path's and the
    # pressed state's picks; the pressed state's cylinder-hull picks differ
    # between envs
    hg = next(g for g in table.groups if g.kind == NEW_KINDS[-1])
    np_rel = np_abs = 0.0
    sets = []
    for d in (d_main, d_press):
        sel = narrowphase.topk_select(collision.broadphase_rank(m, d, tp),
                                      tp.mask, tp.K)
        sets.append((d.geom_xpos, d.geom_xmat, m.geom_size, sel, m.hull_vert,
                     m.hull_face))
        whole = narrowphase.narrowphase(table, *sets[-1])
        rel, ab = table_err(whole, narrowphase.narrowphase_plain(
            table, *sets[-1]), table.rows)
        np_rel, np_abs = max(np_rel, rel), max(np_abs, ab)
        for k in NEW_KINDS:   # alone: the whole table's rows, bit for bit
            sub = table.only([k])
            got = narrowphase.narrowphase(sub, *sets[-1])
            assert all(torch.equal(g[sub.rows].view(torch.int32),
                                   w[sub.rows].view(torch.int32))
                       for g, w in zip(got, whole)), f"{new[k]} alone: bits"
    picks = hg.g2[torch.clamp(sets[1][3][hg.sel_group].long(), 0, len(hg.g2) - 1)]
    n_hulls = int(torch.unique(picks[0]).numel())
    assert n_hulls > 1, "every env picked the same hull"
    assert np_rel <= TOL, f"narrowphase (slide): relerr {np_rel:.3e}"
    out = tuple(torch.empty_like(x) for x in (d_main.contact.dist,
                                              d_main.contact.pos,
                                              d_main.contact.frame))
    args = sets[0]
    n_rows = int(table.rows.numel())
    rows.append(kernel_row(
        "narrowphase_slide", NP_SRC,
        "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:201",
        launches["narrowphase"], np_abs, np_rel,
        time_ms(torch, lambda: narrowphase.narrowphase(table, *args, out=out)),
        time_ms(torch, lambda: narrowphase.narrowphase_plain(
            table, *args, out=out), n=10),
        narrow_bound(m, table, args[3], n_rows, FETCH_B), None,
        [n_rows, FETCH_B],
        ms_int64_picks=int64_picks_ms(torch, narrowphase, tp, (table,) + args, out),
        ms_by_kind=kind_times(torch, narrowphase, table, args, out),
        tasks=int(table.tasks.shape[0])))
    tables["narrowphase_slide"] = table
    for k in NEW_KINDS:
        sub = table.only([k])
        rel, ab = 0.0, 0.0
        for a in sets:
            r_, b_ = table_err(narrowphase.narrowphase(sub, *a),
                               narrowphase.narrowphase_plain(sub, *a), sub.rows)
            rel, ab = max(rel, r_), max(ab, b_)
        name = f"narrowphase_{new[k].replace('-', '_')}"
        rows.append(kernel_row(
            name, NP_SRC,
            "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:201",
            launches["narrowphase"], ab, rel,
            time_ms(torch, lambda: narrowphase.narrowphase(sub, *args, out=out)),
            time_ms(torch, lambda: narrowphase.narrowphase_plain(
                sub, *args, out=out), n=10),
            narrow_bound(m, sub, args[3], int(sub.rows.numel()), FETCH_B),
            None, [int(sub.rows.numel()), FETCH_B],
            envs_penetrating=counts[new[k]], tasks=int(sub.tasks.shape[0]),
            note="the kind's pairs alone (GroupTable.only); on the main path "
                 "it runs inside narrowphase_slide's launches"))
        tables[name] = sub
    print(f"slide kernels: narrowphase relerr {np_rel:.3e}; the pressed "
          f"state's envs picked {n_hulls} distinct hulls for the puck's "
          f"closest pair ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 30. FetchReach main path
    env_r, launches_r, shapes_r = fetch_main(
        torch, dev, card, solver, narrowphase, registry, "FetchReach-v4",
        ((3, 85, 8), (2, 156, 24)), 10, traced=False)

    # --- 31. the card against the CPU plain path from one state
    def check(ref):
        assert ref[0] <= TOL or ref[1] <= max(TOL, NEWTON_SLACK * ref[2]), (
            f"FetchReach card vs CPU path after 1 step: {ref}")
        print(f"reach reference: card vs CPU plain path, {FETCH_REF_ENVS} envs, "
              f"relerr after 1 step {ref}", flush=True)

    fetch_reference(torch, dev, convert, registry, "FetchReach-v4", check)

    # --- 32. FetchReach's kernels: B1 and B2 at nv = 15, topk_select
    t_phase = time.perf_counter()
    m = env_r.env.model
    d_main = pipeline.forward(m, env_r.state.data)
    d_press = pipeline.make_data(m, FETCH_B)   # fingers 0-4 mm in the table
    q = np.tile(env_r.env._init_qpos.cpu().numpy(), (FETCH_B, 1)).T
    lower = 0.1165 + rs.uniform(0, 0.004, FETCH_B)
    q[2] -= lower
    d_press.qpos[:] = cuda(q)
    d_press.mocap_pos[:] = env_r.env._init_mocap_pos[..., None]
    d_press.mocap_pos[:, 2] -= cuda(lower)
    d_press.mocap_quat[:] = env_r.env._init_mocap_quat[..., None]
    d_press = pipeline.forward(m, d_press)
    tp = m.plan("pruned", collision._PrunedPlan)
    rp = m.plan("rows", constraint._RowPlan)
    pen = d_main.contact.dist - m.con_includemargin[:, 0][d_main.contact.src]
    rows += [r for r in topk_rows(torch, narrowphase, rs, cuda, {
        (2, 156, 24): (pen[rp.cap_rows], rp.cap_mask)}, shapes_r, FETCH_B)]
    nv = m.nv
    A = rs.normal(size=(nv, nv, FETCH_B))
    M = cuda(np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None])
    b = cuda(rs.normal(size=(nv, FETCH_B)))
    real = (d_main.qM, d_main.qfrc_smooth)
    systems = {"main qM": real,
               "main damped system": pipeline.damped_system(m, d_main),
               "pressed qM": (d_press.qM, d_press.qfrc_smooth),
               "pressed damped system": pipeline.damped_system(m, d_press)}
    chol_err, chol_abs = check_pair(solver.solve_pos, solver.solve_pos_plain,
                                    [(M, b)] + list(systems.values()))
    assert chol_err <= TOL, f"chol_solve nv=15: relerr {chol_err:.3e}"
    f64 = chol_f64_gate(torch, solver, "chol nv=15", systems)
    Mb = d_main.qM.permute(2, 0, 1).contiguous()
    bb = d_main.qfrc_smooth.T.contiguous()[:, :, None]
    nm = nv * (nv + 1) // 2
    rows.append(kernel_row(
        "chol_solve_nv15", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:455",
        launches_r["chol"], chol_abs, chol_err,
        time_ms(torch, lambda: solver.solve_pos(*real)),
        time_ms(torch, lambda: solver.solve_pos_plain(*real), n=10),
        bound((nm + 2 * nv) * 4 * FETCH_B, chol_ops(nv) * FETCH_B),
        time_ms(torch, lambda: torch.linalg.solve_ex(Mb, bb), graph=False),
        [nv, FETCH_B], f64_rel_err=f64[0], plain32_f64_rel_err=f64[1]))
    n_iter = min(m.opt.iterations, 20)
    n_ls = min(m.opt.ls_iterations, 8)
    sets = []
    for d in (d_main, d_press):
        J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
        sets.append((d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq))
    ne = sets[0][3].shape[0]
    sets.insert(0, (M, cuda(rs.normal(size=(nv, FETCH_B))),
                    cuda(rs.normal(size=(nv, FETCH_B))),
                    cuda(rs.normal(size=(ne, nv, FETCH_B))),
                    cuda(rs.normal(size=(ne, FETCH_B))),
                    cuda(np.exp(rs.normal(size=(ne, FETCH_B)))),
                    cuda(rs.uniform(size=(ne, FETCH_B)) < 0.6, torch.bool),
                    sets[0][7]))
    # the weld and the table squeeze the pressed fingers: held to the
    # plain version's float64 answer as at nv = 21
    errs = [newton_vs_f64(torch, solver, x, n_iter, n_ls) for x in sets]
    print("reach newton nv=15 (random, main, pressed) against the float64 "
          "plain version: (kernel relerr, float32 plain relerr, kernel vs "
          f"float32 plain abs err) {errs}", flush=True)
    for name, (k, p, _) in zip(("random", "main", "pressed"), errs):
        assert k <= max(TOL, NEWTON_SLACK * p), (
            f"newton nv=15 ({name}): relerr {k:.3e} against float64, the "
            f"float32 plain version's {p:.3e}")
    real = sets[1]
    rows.append(kernel_row(
        "newton_nv15", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:249",
        launches_r["newton"], max(a for _, _, a in errs),
        max(k for k, _, _ in errs),
        time_ms(torch, lambda: solver.solve_newton(*real, n_iter=n_iter,
                                                   n_ls=n_ls)),
        time_ms(torch, lambda: solver.solve_newton_plain(
            *real, n_iter=n_iter, n_ls=n_ls), n=5),
        bound((nm + 2 * nv + ne * nv + 3 * ne + nv) * 4 * FETCH_B
              + ne * FETCH_B + ne, newton_ops(nv, ne, n_iter, n_ls) * FETCH_B),
        None, [nv, ne, FETCH_B, n_iter, n_ls],
        plain32_rel_err=max(p for _, p, _ in errs),
        gate="max_rel_err and plain32_rel_err against the plain version in "
             "float64; max_abs_err against it in float32; max_rel_err <= "
             f"max(tolerance, {NEWTON_SLACK} x plain32_rel_err) per set"))
    n_active = [int(x[6][15:].any(dim=0).sum()) for x in sets[1:]]
    print(f"reach kernels: {ne} rows; envs with active contact rows (main, "
          f"pressed) {n_active} ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)
    assert n_active[1] > 0, "no pressed finger touches the table"

    # --- 33. FetchSlide and FetchReach through make_gym (the per-env path)
    t_phase = time.perf_counter()
    grng = np.random.default_rng(4)
    for id_ in ("FetchSlide-v4", "FetchReach-v4"):
        genv = registry.make_gym(id_, parity=True)
        genv.reset(seed=1)
        zero_counters(solver, narrowphase)
        for _ in range(GYM_STEPS_SHORT):
            obs = genv.step(grng.uniform(-1, 1, 4))[0]
            assert all(np.isfinite(v).all() for v in obs.values()), id_
        torch.cuda.synchronize()
        launches = launch_counts(solver, narrowphase)
        assert launches == per_step(GYM_STEPS_SHORT, chol=40, newton=20,
                                    topk=40, narrowphase=20), (id_, launches)
        print(f"single env {id_}: parity reset, {GYM_STEPS_SHORT} steps, "
              f"launches {launches}, "
              f"observation {obs['observation'].shape}", flush=True)
    print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return rows, slide_ctx, tables


def adroit_pressed(torch, pipeline, env, n, seed):
    """(per-env model, forwarded Data) of n envs of an Adroit task pressed:
    the fingers (and the door's hinge and latch) at random angles within
    their ranges, the scene drawn, then the task's object (the door's
    handle, the hammer, the pen, the ball) moved to the grasp site (the
    pen's target ball) plus up to 3 cm, three rounds along its slide joints'
    world axes (the door by its position), so that fingers press into it;
    the hand moving (qvel normal, 0.1)."""
    rs = np.random.RandomState(seed)
    m = env.model
    mt = m.meta
    lo, hi = (m.jnt_range[:, i, 0].cpu().numpy() for i in (0, 1))
    q = np.tile(env._init_qpos.cpu().numpy(), (n, 1))
    for j, name in enumerate(mt.joint_names):
        if name[:2] in ("FF", "MF", "RF", "LF", "TH") or name in (
                "door_hinge", "latch"):
            q[:, mt.jnt_qposadr[j]] = rs.uniform(lo[j], hi[j], n)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    aux = env._sample_aux(n, gen)
    d = pipeline.make_data(m, n)
    d.qpos[:] = env._t(q.T)
    d.qvel[:] = env._t(rs.normal(0, 0.1, (mt.nv, n)))
    site = env._eps_ball if env.task == "pen" else env._grasp_site
    off = env._t(rs.uniform(-0.03, 0.03, (3, n)))
    for _ in range(3):
        k = pipeline.refresh_kin(env._model_for(aux), d)
        target = k.site_xpos[site] + off
        if env.task == "door":
            aux["door_body_pos"] = aux["door_body_pos"] + (
                target - k.site_xpos[env._handle_site]).T
            continue
        err = target - k.xpos[env._obj_body]
        for name in ("OBJTx", "OBJTy", "OBJTz"):
            j = mt.joint_names.index(name)
            d.qpos[mt.jnt_qposadr[j]] += (k.xaxis[j] * err).sum(0)
    mp = env._model_for(aux)
    return mp, pipeline.forward(mp, d)


def jumbled(torch, d, seed):
    """``d`` with every geom at a random pose within a 4 cm cube (random
    rotations), so that every pair of every group is close or overlapping:
    the formulas at poses no main path reaches."""
    rs = np.random.RandomState(seed)
    ng, _, nb = d.geom_xpos.shape
    q = rs.normal(size=(4, ng, nb))
    q /= np.linalg.norm(q, axis=0)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    dev = d.geom_xpos.device
    return dataclasses.replace(
        d, geom_xpos=torch.as_tensor(rs.uniform(-0.02, 0.02, (ng, 3, nb)),
                                     dtype=torch.float32, device=dev),
        geom_xmat=torch.as_tensor(np.moveaxis(R, 2, 0), dtype=torch.float32,
                                  device=dev).contiguous())


def adroit_main(torch, dev, card, solver, narrowphase, registry, id_, steps,
                limit, traced):
    """Phases 34 and 39: ``id_`` x ADROIT_B on the main path (limit
    ``limit``, ``steps`` steps, every env auto-resets with a new scene; per
    step 10 chol, 5 Newton, 10 topk_select (5 of each of its shapes,
    ADROIT_IDS) and 5 narrowphase launches: 5 substeps of 2 Cholesky solves
    (qacc_smooth and the Euler's damped system), a Newton solve, the
    pair-topk broadphase and the contact cap, and the narrowphase of the
    whole compact table), then, if ``traced``, a 1-step trace (phase 35).
    Returns the env and the launches and topk_select shapes counted."""
    t_phase = time.perf_counter()
    env = registry.make(id_, num_envs=ADROIT_B, max_episode_steps=limit)
    obs, _ = env.reset(seed=0)
    nu, width = env.env.action_dim, obs.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(ADROIT_B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(ADROIT_B, dtype=torch.bool, device=dev)
    diverged = torch.zeros(ADROIT_B, dtype=torch.bool, device=dev)
    scene0 = {k: v.clone() for k, v in env.state.aux.items()}
    warm = 2 if steps > 3 else 1
    zero_counters(solver, narrowphase)
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((ADROIT_B, nu), generator=gen, device=dev) * 2 - 1
        obs, _, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs).all(dim=1)
        was_reset |= terminated | truncated
        diverged |= info["diverged"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts(solver, narrowphase)
    counted = dict(narrowphase.TOPK_SHAPES)
    ms_step = wall / (steps - warm) * 1e3
    assert obs.shape == (ADROIT_B, width), obs.shape
    assert bool(finite.all()), f"{id_}: non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    moved = sum(int((v != scene0[k]).reshape(ADROIT_B, -1).any(dim=1).sum())
                for k, v in env.state.aux.items())
    assert moved > 0, f"{id_}: no env drew a new scene at its reset"
    assert launches == per_step(steps, chol=10, newton=5, topk=10,
                                narrowphase=5), launches
    assert counted == {s: 5 * steps for s in ADROIT_IDS[id_]}, counted
    print(f"main path: {id_} x{ADROIT_B}, {steps} steps, limit {limit}, "
          f"launches {launches}, topk_select shapes {counted}; {ms_step:.4f} "
          f"ms/step, {ADROIT_B / ms_step * 1e3:.1f} env-steps/s over steps "
          f"{warm}-{steps}; {moved} scene leaves redrawn by the auto-resets; "
          f"{int(diverged.sum())} envs truncated as diverged [{card}] "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    if traced:
        t_phase = time.perf_counter()

        def run(k):
            for _ in range(k):
                env.step(torch.rand((ADROIT_B, nu), generator=gen, device=dev)
                         * 2 - 1)

        trace(torch, run, 1, card, f"{id_} trace", cpu=False,
              counts=lambda: launch_counts(solver, narrowphase))
        print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return env, launches, counted


def table_f64_gate(narrowphase, table, args, got):
    """The narrowphase kernel's rows ``got`` on ``args`` held to the plain
    version: table_err against the float32 plain version, and per row and
    env each field (its components' largest error, on the field's
    max(1, |ref|)) within TOL of it, except at most one element in a
    thousand, where float32 is ill-conditioned (a normal between two deeply
    overlapping or nearly parallel segments, a face picked among near
    ties): over those the kernel's median error against the plain version
    run in float64 no larger than NEWTON_SLACK times the float32 plain
    version's, as the hand's Newton solve is held by its median env.
    Returns (relerr, abs err, per field the elements so held with their
    kinds and the two medians)."""
    import torch

    ref = narrowphase.narrowphase_plain(table, *args)
    rel, ab = table_err(got, ref, table.rows)
    ref64 = narrowphase.narrowphase_plain(
        table, *(a.double() if a is not None and a.is_floating_point() else a
                 for a in args))
    kind_of = {}
    for g in table.groups:
        for r in range(g.row_off, g.row_off + g.k * g.S):
            kind_of[r] = "-".join(GEOMS[t] for t in narrowphase.KINDS[g.kind])
    rows = table.rows.tolist()
    held = {}
    for name, g, r, r6 in zip(("dist", "pos", "frame"), got, ref, ref64):
        g, r, r6 = (x[table.rows].double().nan_to_num(0.0) for x in (g, r, r6))
        if name == "dist":
            near = (r6 < BIG).double()
            g, r, r6 = g * near, r * near, r6 * near
        scale = max(1.0, float(r6.abs().max()))

        def per(x):   # (rows, B): the largest over the components
            return x.reshape(x.shape[0], -1, x.shape[-1]).amax(1)

        e32, ek, ep = per((g - r).abs()), per((g - r6).abs()), per((r - r6).abs())
        off = e32 > TOL * scale
        n = int(off.sum())
        if not n:
            continue
        med_k, med_p = float(ek[off].median()), float(ep[off].median())
        kinds = sorted({kind_of[rows[i]] for i in off.any(dim=1).nonzero()[:, 0].tolist()})
        held[name] = {"n": n, "kinds": kinds, "kernel_f64_median": med_k,
                      "plain32_f64_median": med_p}
        assert n <= 1e-3 * off.numel() and med_k <= max(TOL * scale,
                                                        NEWTON_SLACK * med_p), (
            f"narrowphase {name}: {held[name]} of {off.numel()} elements beyond "
            f"TOL of the float32 plain version")
    return rel, ab, held


def adroit_tables(torch, narrowphase, collision, m, sets,
                  new_kinds=ADROIT_NEW_KINDS):
    """The narrowphase kernel against its plain version on each
    (label, Data) of ``sets`` (the picks from topk_select on its ranks):
    every kernel row through table_f64_gate, and each of ``new_kinds``
    alone bitwise the whole table's rows; returns ({label: (relerr against
    the float32 plain version, elements held to float64 by field)}, the
    largest abs err, the operand sets)."""
    tp = m.plan("pruned", collision._PrunedPlan)
    table = tp.table
    # the hull tables where a kernel group reads them (the kitchen's
    # plane-hull, cylinder-hull and capsule-hull groups)
    hulls = ((m.hull_vert, m.hull_face)
             if any(g.hull2 is not None for g in table.groups) else ())
    errs, ab, ops = {}, 0.0, []
    for label, d in sets:
        sel = narrowphase.topk_select(collision.broadphase_rank(m, d, tp),
                                      tp.mask, tp.K)
        args = (d.geom_xpos, d.geom_xmat, m.geom_size, sel) + hulls
        whole = narrowphase.narrowphase(table, *args)
        rel, a, held = table_f64_gate(narrowphase, table, args, whole)
        errs[label], ab = (rel, held), max(ab, a)
        for k in {g.kind for g in table.groups} & set(new_kinds):
            sub = table.only([k])
            got = narrowphase.narrowphase(sub, *args)
            assert all(torch.equal(g[sub.rows].view(torch.int32),
                                   w[sub.rows].view(torch.int32))
                       for g, w in zip(got, whole)), f"kind {k} alone ({label}): bits"
        ops.append(args)
    return errs, ab, ops


def penetrating(narrowphase, table, d):
    """{kind name: envs with a penetrating row of that kind}."""
    out = {}
    for g in table.groups:
        name = "-".join(GEOMS[t] for t in narrowphase.KINDS[g.kind])
        rows = d.contact.dist[g.row_off:g.row_off + g.k * g.S]
        out[name] = out.get(name, 0) + int((rows < 0).any(dim=0).sum())
    return out


def solver_rows(torch, dev, solver, constraint, pipeline, m, d_main, d_press,
                launches, rs, label, newton_name=None, chol=True):
    """B1 and B2 at m's nv (phase 37; B1 alone, in a row named
    ``newton_name``, with chol=False): the Cholesky on random SPD systems,
    the main path's and the pressed state's qM and damped systems, within
    TOL of its plain version and held to the plain version in float64; the
    Newton solve on random rows, the main path's and the pressed state's,
    held to the plain version in float64 env by env (its median env within
    TOL, or no further than NEWTON_SLACK times the float32 plain version's
    median env), as at nv = 36; the JSON rows with times, bounds and
    solve_ex beside the Cholesky."""
    nv, nb = m.nv, d_main.qpos.shape[-1]

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    A = rs.normal(size=(nv, nv, nb))
    M = cuda(np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None])
    b = cuda(rs.normal(size=(nv, nb)))
    real = (d_main.qM, d_main.qfrc_smooth)
    # a pressed env whose forward overflowed (kitchen_pressed) has no
    # damped system: the Cholesky takes the others
    keep = (torch.isfinite(d_press.qacc).all(dim=0)
            & torch.isfinite(d_press.qfrc_constraint).all(dim=0)).nonzero()[:, 0]

    def envs(sys_):
        return tuple(x[..., keep] for x in sys_)

    rows = []
    nm = nv * (nv + 1) // 2
    if chol:
        systems = {"main qM": real,
                   "main damped system": pipeline.damped_system(m, d_main),
                   "pressed qM": envs((d_press.qM, d_press.qfrc_smooth)),
                   "pressed damped system": envs(pipeline.damped_system(m, d_press))}
        chol_err, chol_abs = check_pair(solver.solve_pos, solver.solve_pos_plain,
                                        [(M, b)] + list(systems.values()))
        assert chol_err <= TOL, f"chol_solve nv={nv}: relerr {chol_err:.3e}"
        f64 = chol_f64_gate(torch, solver, f"{label} chol nv={nv}", systems)
        Mb = d_main.qM.permute(2, 0, 1).contiguous()
        bb = d_main.qfrc_smooth.T.contiguous()[:, :, None]
        rows.append(kernel_row(
            f"chol_solve_nv{nv}", SOLVER_SRC,
            "gymnasium_robotics_tpu/physics/solver_pallas.py:455",
            launches["chol"], chol_abs, chol_err,
            time_ms(torch, lambda: solver.solve_pos(*real)),
            time_ms(torch, lambda: solver.solve_pos_plain(*real), n=10),
            bound((nm + 2 * nv) * 4 * nb, chol_ops(nv) * nb),
            time_ms(torch, lambda: torch.linalg.solve_ex(Mb, bb), graph=False),
            [nv, nb], f64_rel_err=f64[0], plain32_f64_rel_err=f64[1]))
    n_iter = min(m.opt.iterations, 20)
    n_ls = min(m.opt.ls_iterations, 8)
    sets = []
    for d in (d_main, d_press):
        J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
        sets.append((d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq))
    ne = sets[0][3].shape[0]
    sets.insert(0, (M, cuda(rs.normal(size=(nv, nb))), cuda(rs.normal(size=(nv, nb))),
                    cuda(rs.normal(size=(ne, nv, nb)) * 0.3),
                    cuda(rs.normal(size=(ne, nb))),
                    cuda(np.exp(rs.normal(size=(ne, nb)))),
                    cuda(rs.uniform(size=(ne, nb)) < 0.4, torch.bool), sets[0][7]))
    # an env whose float32 solve overflows (the kernel's and the plain
    # version's alike; the kitchen's deepest pressed arms) is counted and
    # left out of the medians and the per-env bound; the kernel may not
    # overflow where the float32 plain version does not. Each env finite in
    # both is held to max(TOL, NEWTON_SLACK x the float32 plain version's
    # error); an env past that (an ill-conditioned solve, where 8 Newton
    # iterations from float32 inputs land anywhere within the rounding's
    # reach) is held to NEWTON_SLACK x the float32 plain version's spread
    # over inputs perturbed at the rounding's scale (newton_spread)
    stats, k_abs = {}, 0.0
    for si, (name, x) in enumerate(zip(("random", "main", "pressed"), sets)):
        e = newton_env_errs(torch, solver, x, n_iter, n_ls)
        bad = ~np.isfinite(e[:2])
        assert not (bad[0] & ~bad[1]).any(), (
            f"newton nv={nv} ({name}): envs {np.nonzero(bad[0] & ~bad[1])[0]} "
            "not finite in the kernel only")
        ok = ~bad[1]
        k, p, kp = e[0][ok], e[1][ok], e[2][ok]
        beyond = np.nonzero(k > np.maximum(TOL, NEWTON_SLACK * p))[0]
        spread = (newton_spread(torch, solver, x, np.nonzero(ok)[0][beyond],
                                n_iter, n_ls, si) if beyond.size else np.zeros(0))
        w = int(np.argmax(k))
        stats[name] = {"kernel_median": float(np.median(k)),
                       "plain32_median": float(np.median(p)),
                       "kernel_max": float(k.max()),
                       "plain32_max": float(p.max()),
                       "envs_not_finite": [int(bad[0].sum()), int(bad[1].sum())],
                       "envs_beyond_slack": int(beyond.size),
                       "worst_env": {
                           "env": int(np.nonzero(ok)[0][w]),
                           "kernel_f64": float(k[w]), "plain32_f64": float(p[w]),
                           "kernel_plain32": float(kp[w]),
                           "plain32_spread": (float(spread[beyond == w][0])
                                              if (beyond == w).any() else None)},
                       "beyond": [[float(k[j]), float(p[j]), float(kp[j]),
                                   float(sp)] for j, sp in zip(beyond, spread)]}
        for j, sp in zip(beyond, spread):
            assert k[j] <= NEWTON_SLACK * max(TOL, sp), (
                f"newton nv={nv} ({name}): env {int(np.nonzero(ok)[0][j])} relerr "
                f"{k[j]:.3e} against float64, the float32 plain version's "
                f"{p[j]:.3e} and its spread over perturbed inputs {sp:.3e}")
        got = solver.solve_newton(*x, n_iter=n_iter, n_ls=n_ls)
        ref = solver.solve_newton_plain(*x, n_iter=n_iter, n_ls=n_ls)
        k_abs = max(k_abs, max(float((g.double() - r.double()).abs().nan_to_num(
            0.0, 0.0, 0.0).max()) for g, r in zip(got, ref)))
    print(f"{label} newton nv={nv} ({ne} rows) against the float64 plain "
          f"version, env by env (beyond: [kernel, plain32, kernel vs plain32, "
          f"plain32 spread] of each env past the slack): {json.dumps(stats)}",
          flush=True)
    for name, st in stats.items():
        assert st["kernel_median"] <= max(TOL, NEWTON_SLACK * st["plain32_median"]), (
            f"newton nv={nv} ({name}): median env relerr {st['kernel_median']:.3e}"
            f" against float64, the float32 plain version's "
            f"{st['plain32_median']:.3e}")
    real = sets[1]
    rows.append(kernel_row(
        newton_name or f"newton_nv{nv}", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:249",
        launches["newton"], k_abs,
        max(st["kernel_median"] for st in stats.values()),
        time_ms(torch, lambda: solver.solve_newton(*real, n_iter=n_iter,
                                                   n_ls=n_ls)),
        time_ms(torch, lambda: solver.solve_newton_plain(
            *real, n_iter=n_iter, n_ls=n_ls), n=5),
        bound((nm + 2 * nv + ne * nv + 3 * ne + nv) * 4 * nb + ne * nb + ne,
              newton_ops(nv, ne, n_iter, n_ls) * nb),
        None, [nv, ne, nb, n_iter, n_ls], by_set=stats,
        gate="max_rel_err: the largest median env relerr against the plain "
             "version in float64 over the sets (by_set); max_abs_err against "
             "it in float32; each set's median env <= max(tolerance, "
             f"{NEWTON_SLACK} x the float32 plain version's), and each env "
             f"finite in both <= max(tolerance, {NEWTON_SLACK} x the float32 "
             f"plain version's) or <= {NEWTON_SLACK} x max(tolerance, its "
             f"spread over inputs perturbed by {SPREAD_REL:g})"))
    return rows


def adroit_slice(torch, dev, card, solver, constraint, narrowphase, collision,
                 pipeline, convert, registry):
    """Phases 34-39 (the Adroit family); returns the kernels' JSON rows,
    Door's pressed state (model, data) for the edge checks, and the
    narrowphase rows' group tables by row name."""
    rows, tables = [], {}
    rs = np.random.RandomState(10)
    door_id = "AdroitHandDoor-v1"
    # --- 34-35. AdroitHandDoor main path and trace
    env, launches, shapes = adroit_main(torch, dev, card, solver, narrowphase,
                                        registry, door_id, ADROIT_STEPS,
                                        ADROIT_LIMIT, traced=True)

    # --- 36. the card against the CPU plain path from one state
    reference_gate(door_id, {"main": env_reference(
        torch, dev, convert, registry, door_id, env.state, 1.0,
        ADROIT_REF_ENVS)}, ADROIT_REF_ENVS)

    # --- 37. Door's kernels: B4's new kinds, B1 and B2 at nv = 30, B3
    t_phase = time.perf_counter()
    denv = env.env
    m = denv._model_for(env.state.aux)
    d_main = pipeline.forward(m, env.state.data)
    m_p, d_press = adroit_pressed(torch, pipeline, denv, ADROIT_B, 14)
    tp = m.plan("pruned", collision._PrunedPlan)
    rp = m.plan("rows", constraint._RowPlan)
    table = tp.table
    pen_counts = {"main": penetrating(narrowphase, table, d_main),
                  "pressed": penetrating(narrowphase, table, d_press)}
    print(f"door kernels: envs with a penetrating row per kind "
          f"{json.dumps(pen_counts)}", flush=True)
    for kind in ("capsule-cylinder", "capsule-capsule"):
        assert pen_counts["pressed"][kind] > 0, f"no pressed {kind} row penetrates"
    errs, np_abs, ops = adroit_tables(
        torch, narrowphase, collision, m,
        [("main", d_main), ("pressed", d_press), ("jumbled", jumbled(torch, d_main, 5))])
    print(f"door kernels: narrowphase (relerr against the float32 plain "
          f"version, elements held to float64 by field) {errs}", flush=True)
    pen = d_main.contact.dist - m.con_includemargin[:, 0][d_main.contact.src]
    shp = ADROIT_IDS[door_id]
    rows += topk_rows(torch, narrowphase, rs, lambda x, dtype=torch.float32:
                      torch.as_tensor(np.asarray(x), dtype=dtype, device=dev), {
                          shp[0]: (collision.broadphase_rank(m, d_main, tp), tp.mask),
                          shp[1]: (pen[rp.cap_rows], rp.cap_mask)},
                      shapes, ADROIT_B)
    out = tuple(torch.empty_like(x) for x in (d_main.contact.dist,
                                              d_main.contact.pos,
                                              d_main.contact.frame))
    args = ops[0]
    n_rows = int(table.rows.numel())
    rows.append(kernel_row(
        "narrowphase_door", NP_SRC,
        "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:201",
        launches["narrowphase"], np_abs, max(e[0] for e in errs.values()),
        time_ms(torch, lambda: narrowphase.narrowphase(table, *args, out=out)),
        time_ms(torch, lambda: narrowphase.narrowphase_plain(
            table, *args, out=out), n=5),
        narrow_bound(m, table, args[3], n_rows, ADROIT_B), None,
        [n_rows, ADROIT_B],
        ms_by_kind=kind_times(torch, narrowphase, table, args, out),
        tasks=int(table.tasks.shape[0]), by_set=errs,
        gate="table_f64_gate: each element within tolerance of the float32 "
             "plain version but at most 1e-3 of them, whose median error "
             "against the float64 plain version is within "
             f"{NEWTON_SLACK}x the float32 plain version's"))
    tables["narrowphase_door"] = table
    for k in ADROIT_NEW_KINDS[:3]:
        rows.append(kind_row(torch, narrowphase, table, k, ops, out,
                             launches["narrowphase"], m, pen_counts, "door"))
        tables[rows[-1]["name"]] = table.only([k])
    rows += solver_rows(torch, dev, solver, constraint, pipeline, m, d_main,
                        d_press, launches, rs, "door")
    print(f"door kernels ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    door_ctx = (m_p, d_press, None)

    # --- 38. make_gym("AdroitHandDoor-v1"): the per-env path
    t_phase = time.perf_counter()
    genv = registry.make_gym(door_id, parity=True)
    genv.reset(seed=1)
    grng = np.random.default_rng(4)
    zero_counters(solver, narrowphase)
    for _ in range(3):
        obs = genv.step(grng.uniform(-1, 1, 28))[0]
        assert np.isfinite(obs).all() and obs.shape == (39,)
    torch.cuda.synchronize()
    launches_g = launch_counts(solver, narrowphase)
    assert launches_g == per_step(3, chol=10, newton=5, topk=10,
                                  narrowphase=5), launches_g
    print(f"single env {door_id}: parity reset, 3 steps, launches "
          f"{launches_g}, observation {obs.shape} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 39. Hammer, Pen and Relocate: main paths, references, tables
    for id_ in ("AdroitHandHammer-v1", "AdroitHandPen-v1",
                "AdroitHandRelocate-v1"):
        e, la, sh = adroit_main(torch, dev, card, solver, narrowphase, registry,
                                id_, 3, 2, traced=False)
        t_phase = time.perf_counter()
        reference_gate(id_, {"main": env_reference(
            torch, dev, convert, registry, id_, e.state, 1.0,
            ADROIT_REF_ENVS)}, ADROIT_REF_ENVS)
        te = e.env
        m = te._model_for(e.state.aux)
        d_main = pipeline.forward(m, e.state.data)
        m_p, d_press = adroit_pressed(torch, pipeline, te, ADROIT_B, 11)
        tp = m.plan("pruned", collision._PrunedPlan)
        rp = m.plan("rows", constraint._RowPlan)
        table = tp.table
        pc = {"main": penetrating(narrowphase, table, d_main),
              "pressed": penetrating(narrowphase, table, d_press)}
        errs, np_abs, ops = adroit_tables(
            torch, narrowphase, collision, m,
            [("main", d_main), ("pressed", d_press),
             ("jumbled", jumbled(torch, d_main, 6))])
        print(f"{id_} kernels: envs with a penetrating row per kind "
              f"{json.dumps(pc)}; narrowphase (relerr, elements held to "
              f"float64) {errs}", flush=True)
        pen = d_main.contact.dist - m.con_includemargin[:, 0][d_main.contact.src]
        shp = ADROIT_IDS[id_]
        rows += topk_rows(torch, narrowphase, rs, lambda x, dtype=torch.float32:
                          torch.as_tensor(np.asarray(x), dtype=dtype, device=dev), {
                              shp[0]: (collision.broadphase_rank(m, d_main, tp), tp.mask),
                              shp[1]: (pen[rp.cap_rows], rp.cap_mask)},
                          sh, ADROIT_B)
        if id_ == "AdroitHandRelocate-v1":
            assert pc["pressed"]["sphere-capsule"] > 0, "no pressed ball row"
            out = tuple(torch.empty_like(x) for x in (d_main.contact.dist,
                                                      d_main.contact.pos,
                                                      d_main.contact.frame))
            rows.append(kind_row(torch, narrowphase, table, 13, ops, out,
                                 la["narrowphase"], m, pc, "relocate"))
            tables[rows[-1]["name"]] = table.only([13])
        if id_ == "AdroitHandHammer-v1":
            rows += solver_rows(torch, dev, solver, constraint, pipeline, m,
                                d_main, d_press, la, rs, "hammer")
        print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return rows, door_ctx, tables


def reach_pressed(torch, pipeline, env, n, seed):
    """Forwarded Data of n HandReach hands with every joint drawn from its
    range widened by 0.3 below and 0.9 above (fingers bent past their
    limits into the palm and each other: capsule-box, box-box and
    plane-capsule rows penetrate, joint and tendon limits active), moving
    (qvel normal, 0.1)."""
    rs = np.random.RandomState(seed)
    m = env.model
    lo, hi = (m.jnt_range[:, i, 0].cpu().numpy() for i in (0, 1))
    q = (lo - 0.3)[None] + rs.uniform(size=(n, m.nq)) * (hi - lo + 1.2)[None]
    d = pipeline.make_data(m, n)
    d.qpos[:] = env._t(q.T)
    d.qvel[:] = env._t(rs.normal(0, 0.1, (m.nv, n)))
    return pipeline.forward(m, d)


def step_launches(m, substeps, pruned):
    """The launches of one env step of ``substeps`` substeps of model m: a
    Cholesky for qacc_smooth and, with joint damping, one for the Euler's
    damped velocity; the Newton solve; the contact cap's topk_select
    (every capped condim group in one call) and, on a pair-topk table, the
    broadphase's and the narrowphase kernel."""
    chol = 1 + int(m.meta.has_damping)
    return dict(chol=chol * substeps, newton=substeps,
                topk=(1 + int(pruned)) * substeps,
                narrowphase=int(pruned) * substeps)


def reach_slice(torch, dev, card, solver, constraint, narrowphase, pipeline,
                convert, registry):
    """Phases 40-43 (HandReach-v3: B1 and B2 at nv = 24); returns the
    kernels' JSON rows."""
    # --- 40. main path and trace
    t_phase = time.perf_counter()
    env = registry.make(REACH_ID, num_envs=REACH_B, max_episode_steps=REACH_LIMIT)
    obs, _ = env.reset(seed=0)
    renv, m = env.env, env.env.model
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(REACH_B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(REACH_B, dtype=torch.bool, device=dev)
    diverged = torch.zeros(REACH_B, dtype=torch.bool, device=dev)
    goal0 = obs["desired_goal"].clone()
    warm = 1
    zero_counters(solver, narrowphase)
    for i in range(REACH_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((REACH_B, 20), generator=gen, device=dev) * 2 - 1
        obs, _, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs["observation"]).all(dim=1)
        was_reset |= terminated | truncated
        diverged |= info["diverged"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts(solver, narrowphase)
    shapes = dict(narrowphase.TOPK_SHAPES)
    n = REACH_STEPS
    ms_step = wall / (n - warm) * 1e3
    assert obs["observation"].shape == (REACH_B, 63), obs["observation"].shape
    assert bool(finite.all()), "non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    redrawn = int((obs["desired_goal"] != goal0).any(dim=1).sum())
    assert redrawn > 0, "no env drew a new goal at its reset"
    per = step_launches(m, renv.n_substeps, pruned=False)
    assert launches == per_step(n, **per), launches
    assert shapes == {(2, 160, 16): 20 * n}, shapes
    print(f"main path: {REACH_ID} x{REACH_B}, {n} steps, limit {REACH_LIMIT} "
          f"(cut from 50: every env resets), launches {launches}; "
          f"{ms_step:.4f} ms/step, {REACH_B / ms_step * 1e3:.1f} env-steps/s "
          f"over steps {warm}-{n}; {redrawn} goals redrawn by the auto-resets; "
          f"{int(diverged.sum())} envs truncated as diverged [{card}] "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    t_phase = time.perf_counter()

    def run(k):
        for _ in range(k):
            env.step(torch.rand((REACH_B, 20), generator=gen, device=dev) * 2 - 1)

    trace(torch, run, 1, card, f"{REACH_ID} trace", cpu=False,
          counts=lambda: launch_counts(solver, narrowphase),
          window=(renv, "n_substeps"))
    print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 41. the card against the CPU plain path from one state
    reference_gate(REACH_ID, {"main": env_reference(
        torch, dev, convert, registry, REACH_ID, env.state, 1.0,
        REACH_REF_ENVS)}, REACH_REF_ENVS)

    # --- 42. B1 and B2 at nv = 24 on random, the main path's and pressed rows
    t_phase = time.perf_counter()
    d_main = pipeline.forward(m, env.state.data)
    d_press = reach_pressed(torch, pipeline, renv, REACH_B, 12)
    n_pen = [int((d.contact.dist < 0).any(dim=0).sum()) for d in (d_main, d_press)]
    print(f"reach kernels: envs with a penetrating slot (main path, pressed "
          f"hands) {n_pen}", flush=True)
    assert n_pen[1] > 0, "no pressed hand touches"
    rows = solver_rows(torch, dev, solver, constraint, pipeline, m, d_main,
                       d_press, launches, np.random.RandomState(24), "reach")
    print(f"reach kernels ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 43. make_gym: the per-env path
    t_phase = time.perf_counter()
    genv = registry.make_gym(REACH_ID, parity=True)
    genv.reset(seed=1)
    grng = np.random.default_rng(2)
    zero_counters(solver, narrowphase)
    for _ in range(GYM_STEPS_SHORT):
        obs = genv.step(grng.uniform(-1, 1, 20))[0]
        assert obs["observation"].shape == (63,) and all(
            np.isfinite(v).all() for v in obs.values()), REACH_ID
    torch.cuda.synchronize()
    launches = launch_counts(solver, narrowphase)
    assert launches == per_step(GYM_STEPS_SHORT, **per), launches
    print(f"single env {REACH_ID}: parity reset, {GYM_STEPS_SHORT} steps, "
          f"launches {launches} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return rows


def kitchen_noise(n, seed):
    """Host-drawn observation noise of n kitchen envs (the parity sampler's
    keys, raw U(-1, 1))."""
    rs = np.random.RandomState(seed)
    return {k: rs.uniform(-1.0, 1.0, (n, s))
            for k, s in (("robot_pos", 9), ("robot_vel", 9), ("obj_pos", 21),
                         ("obj_vel", 20))}


def kitchen_pressed(torch, pipeline, env, n, seed):
    """Forwarded Data of n kitchens with the arm's seven joints turned by
    up to 1.2 rad at random (into the cabinets, the counter and the
    kettle: capsule-hull, box-hull, hull-hull, capsule-box, box-box and
    cylinder rows penetrate), moving (qvel normal, 0.1 on the arm). No
    draw is thrown away: the deepest arms' float32 solves may overflow
    (in the forward here, or in a solve warm-started from its qacc), in the
    kernel and the plain version alike; solver_rows counts those envs."""
    rs = np.random.RandomState(seed)
    m = env.model
    q = np.tile(env._init_qpos.cpu().numpy(), (n, 1))
    q[:, :7] += rs.uniform(-1.2, 1.2, (n, 7))
    v = np.zeros((n, m.nv))
    v[:, :7] = rs.normal(0, 0.1, (n, 7))
    d = pipeline.make_data(m, n)
    d.qpos[:] = env._t(q.T)
    d.qvel[:] = env._t(v.T)
    d = pipeline.forward(m, d)
    bad = ~(torch.isfinite(d.qacc).all(dim=0)
            & torch.isfinite(d.qfrc_constraint).all(dim=0))
    print(f"kitchen pressed: {int(bad.sum())} of {n} envs' forward not finite, "
          f"largest finite |qacc| {float(d.qacc[:, ~bad].abs().max()):.3e}",
          flush=True)
    return d


def kitchen_lifted(torch, registry, n, seed):
    """The state of n kitchens just reset, the arm's joints moving (qvel
    normal, 0.3) and the kettle raised 5 cm off the stove, so that it falls
    free through the step: no stiff contact row holds it, and the float32
    step is well-conditioned (tests/test_torch_kitchen.py's "lifted")."""
    e = registry.make(KITCHEN_ID, num_envs=n)
    e.reset(seed=seed)
    s = e.state
    rs = np.random.RandomState(seed)
    qpos, qvel = s.data.qpos.clone(), s.data.qvel.clone()
    qpos[KETTLE_Z] += 0.05
    qvel[:7] = torch.as_tensor(rs.normal(0, 0.3, (7, n)), dtype=qvel.dtype,
                               device=qvel.device)
    return dataclasses.replace(s, data=dataclasses.replace(s.data, qpos=qpos,
                                                           qvel=qvel))


def kitchen_slice(torch, dev, card, solver, constraint, narrowphase, collision,
                  pipeline, convert, registry):
    """Phases 44-47 (FrankaKitchen-v1: B4's capsule-hull kind and the
    kitchen's whole table, topk_select at its two shapes, B1 and B2 at
    nv = 29); returns the kernels' JSON rows and the narrowphase rows'
    group tables by row name."""
    # --- 44. main path and trace
    t_phase = time.perf_counter()
    env = registry.make(KITCHEN_ID, num_envs=KITCHEN_B,
                        max_episode_steps=KITCHEN_LIMIT)
    obs, _ = env.reset(seed=0)
    kenv, m = env.env, env.env.model
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(KITCHEN_B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(KITCHEN_B, dtype=torch.bool, device=dev)
    diverged = torch.zeros(KITCHEN_B, dtype=torch.bool, device=dev)
    warm = 1
    zero_counters(solver, narrowphase)
    for i in range(KITCHEN_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((KITCHEN_B, 9), generator=gen, device=dev) * 2 - 1
        obs, reward, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs["observation"]).all(dim=1)
        was_reset |= terminated | truncated
        diverged |= info["diverged"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts(solver, narrowphase)
    shapes = dict(narrowphase.TOPK_SHAPES)
    n = KITCHEN_STEPS
    ms_step = wall / (n - warm) * 1e3
    tp = m.plan("pruned", collision._PrunedPlan)
    rp = m.plan("rows", constraint._RowPlan)
    shp = ((int(tp.mask.shape[0]), int(tp.mask.shape[1]), tp.K),
           (int(rp.cap_mask.shape[0]), int(rp.cap_mask.shape[1]), rp.cap))
    assert obs["observation"].shape == (KITCHEN_B, 59), obs["observation"].shape
    assert info["tasks_to_complete"].shape == (KITCHEN_B, 7)
    assert bool(finite.all()), "non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    per = step_launches(m, kenv.frame_skip, pruned=True)
    assert launches == per_step(n, **per), launches
    assert shapes == {s: kenv.frame_skip * n for s in shp}, shapes
    print(f"main path: {KITCHEN_ID} x{KITCHEN_B}, {n} steps, limit "
          f"{KITCHEN_LIMIT} (cut from 280: every env resets), launches "
          f"{launches}, topk_select shapes {shapes}; {ms_step:.4f} ms/step, "
          f"{KITCHEN_B / ms_step * 1e3:.1f} env-steps/s over steps {warm}-{n}; "
          f"{int(diverged.sum())} envs truncated as diverged [{card}] "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    t_phase = time.perf_counter()

    def run(k):
        for _ in range(k):
            env.step(torch.rand((KITCHEN_B, 9), generator=gen, device=dev) * 2 - 1)

    trace(torch, run, 1, card, f"{KITCHEN_ID} trace", cpu=False,
          counts=lambda: launch_counts(solver, narrowphase),
          window=(kenv, "frame_skip"))
    print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 45. step_with_values: the card against the CPU plain path, from
    # the main path's state (its kettle on the stove: float64 by the median
    # env) and from a reset with the kettle lifted (CPU float32, every env)
    reference_gate(KITCHEN_ID, {
        name: env_reference(torch, dev, convert, registry, KITCHEN_ID, st, 1.0,
                            KITCHEN_REF_ENVS,
                            values=kitchen_noise(KITCHEN_REF_ENVS, 3))
        for name, st in (("main", env.state),
                         ("lifted", kitchen_lifted(torch, registry,
                                                   KITCHEN_REF_ENVS, 5)))},
        KITCHEN_REF_ENVS, strict=("lifted",))

    # --- 46. kernels: the whole table and capsule-hull alone, B3, B1, B2
    t_phase = time.perf_counter()
    rs = np.random.RandomState(29)
    d_main = pipeline.forward(m, env.state.data)
    d_press = kitchen_pressed(torch, pipeline, kenv, KITCHEN_B, 15)
    table = tp.table
    pen_counts = {"main": penetrating(narrowphase, table, d_main),
                  "pressed": penetrating(narrowphase, table, d_press)}
    print(f"kitchen kernels: envs with a penetrating row per kind "
          f"{json.dumps(pen_counts)}", flush=True)
    assert pen_counts["pressed"]["capsule-hull"] > 0, "no pressed capsule-hull row"
    errs, np_abs, ops = adroit_tables(
        torch, narrowphase, collision, m,
        [("main", d_main), ("pressed", d_press),
         ("jumbled", jumbled(torch, d_main, 7))], new_kinds=KITCHEN_NEW_KINDS)
    print(f"kitchen kernels: narrowphase (relerr against the float32 plain "
          f"version, elements held to float64 by field) {errs}", flush=True)
    pen = d_main.contact.dist - m.con_includemargin[:, 0][d_main.contact.src]
    rows = topk_rows(torch, narrowphase, rs, lambda x, dtype=torch.float32:
                     torch.as_tensor(np.asarray(x), dtype=dtype, device=dev), {
                         shp[0]: (collision.broadphase_rank(m, d_main, tp), tp.mask),
                         shp[1]: (pen[rp.cap_rows], rp.cap_mask)},
                     shapes, KITCHEN_B)
    out = tuple(torch.empty_like(x) for x in (d_main.contact.dist,
                                              d_main.contact.pos,
                                              d_main.contact.frame))
    args = ops[0]
    n_rows = int(table.rows.numel())
    rows.append(kernel_row(
        "narrowphase_kitchen", NP_SRC,
        "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:201",
        launches["narrowphase"], np_abs, max(e[0] for e in errs.values()),
        time_ms(torch, lambda: narrowphase.narrowphase(table, *args, out=out)),
        time_ms(torch, lambda: narrowphase.narrowphase_plain(
            table, *args, out=out), n=5),
        narrow_bound(m, table, args[3], n_rows, KITCHEN_B), None,
        [n_rows, KITCHEN_B],
        ms_by_kind=kind_times(torch, narrowphase, table, args, out),
        tasks=int(table.tasks.shape[0]), by_set=errs,
        gate="table_f64_gate: each element within tolerance of the float32 "
             "plain version but at most 1e-3 of them, whose median error "
             "against the float64 plain version is within "
             f"{NEWTON_SLACK}x the float32 plain version's"))
    tables = {"narrowphase_kitchen": table}
    for k in KITCHEN_NEW_KINDS:
        rows.append(kind_row(torch, narrowphase, table, k, ops, out,
                             launches["narrowphase"], m, pen_counts, "kitchen"))
        tables[rows[-1]["name"]] = table.only([k])
    rows += solver_rows(torch, dev, solver, constraint, pipeline, m, d_main,
                        d_press, launches, rs, "kitchen")
    print(f"kitchen kernels ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 47. make_gym(parity=True): the per-env path on the card; its step
    # draws the observation noise from np_random after the reset's draws,
    # so it equals step_with_values given that sequence's next draw
    t_phase = time.perf_counter()
    from gymnasium_robotics_tpu_torch.utils import parity

    genv = registry.make_gym(KITCHEN_ID, parity=True)
    genv.reset(seed=1)
    state0 = genv._state
    rng = np.random.default_rng(1)
    parity.sample_reset_values(genv.env, rng)
    values = {k: v[None] for k, v in parity.sample_step_values(genv.env, rng).items()}
    a = np.random.default_rng(4).uniform(-1, 1, 9)
    zero_counters(solver, narrowphase)
    o = genv.step(a)[0]
    torch.cuda.synchronize()
    launches_g = launch_counts(solver, narrowphase)
    assert launches_g == per_step(1, **per), launches_g
    ref = genv.env.step_with_values(
        state0, torch.as_tensor(a[None], dtype=torch.float32, device=dev), values)
    err = rel_err(torch.as_tensor(o["observation"]),
                  ref.obs["observation"][0].cpu())
    print(f"single env {KITCHEN_ID}: parity reset and 1 step, the step's "
          f"observation noise from np_random; launches {launches_g}; relerr "
          f"{err:.3e} against step_with_values given the sequence's next "
          f"draws ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    assert err <= TOL, f"make_gym {KITCHEN_ID}: relerr {err:.3e}"
    return rows, tables


def loco_launches(m, frame_skip, nv2=False):
    """Per-env-step launches of a locomotion model: a forward per Euler
    substep, four per RK4 substep, each with a Cholesky for qacc_smooth
    and a Newton solve (the closed-form nv = 2 route with ``nv2``); the
    Euler's damped velocity solve with joint damping; no narrowphase or
    topk_select (unpruned tables, no contact cap)."""
    rk4 = m.meta.opt.integrator == 1
    fwd = frame_skip * (4 if rk4 else 1)
    chol = fwd + (frame_skip if not rk4 and m.meta.has_damping else 0)
    return dict(chol=chol, **({"newton_nv2": fwd} if nv2 else {"newton": fwd}))


def loco_run(torch, dev, card, solver, narrowphase, registry, id_, nb, steps,
             limit, label="main path"):
    """registry.make(id_, num_envs=nb, max_episode_steps=limit), reset,
    ``steps`` steps with random actions in [-1, 1] (past the limit: every
    env resets); the launches per step must be the model's
    (loco_launches), the observations finite and of the env's width.
    Returns (the batched env, the launches, ms/step over steps 1..)."""
    t_phase = time.perf_counter()
    env = registry.make(id_, num_envs=nb, max_episode_steps=limit)
    env.reset(seed=0)
    lenv, m = env.env, env.env.model
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(nb, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(nb, dtype=torch.bool, device=dev)
    diverged = torch.zeros(nb, dtype=torch.bool, device=dev)
    warm = 1
    zero_counters(solver, narrowphase)
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((nb, lenv.action_dim), generator=gen, device=dev) * 2 - 1
        obs, _, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs).all(dim=1)
        was_reset |= terminated | truncated
        diverged |= info["diverged"]
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t_start) / (steps - warm) * 1e3
    launches = launch_counts(solver, narrowphase)
    per = loco_launches(m, lenv.cfg.frame_skip)
    assert obs.shape == (nb, lenv.obs_dim), (id_, obs.shape)
    assert bool(finite.all()), f"{id_}: non-finite observations"
    if steps > limit:
        assert bool(was_reset.all()), f"{id_}: {int((~was_reset).sum())} envs never reset"
    assert launches == per_step(steps, **per), (id_, launches)
    from gymnasium_robotics_tpu_torch.physics import constraint

    ne = m.plan("rows", constraint._RowPlan).is_eq.numel()
    shape = (solver.newton_shape(m.nv, ne) if m.nv in solver.NEWTON_TILE_SHAPES
             else "newton2_kernel")
    print(f"{label}: {id_} x{nb}, {steps} steps, limit {limit}, nv = {m.nv}, "
          f"{ne} rows (newton_tile_kernel shape {shape}), launches {launches}; "
          f"{ms_step:.4f} ms/step, {nb / ms_step * 1e3:.1f} env-steps/s over "
          f"steps {warm}-{steps}; {int(was_reset.sum())} envs reset, "
          f"{int(diverged.sum())} truncated as diverged [{card}] "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return env, launches, ms_step


def loco_pressed(torch, pipeline, env, n, seed):
    """Forwarded Data of n envs of a locomotion model pressed into the floor
    and into its own limits: every limited joint drawn from its range
    widened by 0.3 rad (or m) each way, an unlimited hinge turned within
    0.5 rad, a vertical slide (the planar root's height) lowered by up to
    0.3 m, a free root lowered to 30-80 % of its height; qvel normal, 0.5."""
    rs = np.random.RandomState(seed)
    m = env.model
    mt = m.meta
    q = np.repeat(m.qpos0[:, 0].double().cpu().numpy()[None], n, axis=0)
    rng = m.jnt_range[..., 0].double().cpu().numpy()
    axis = m.jnt_axis[..., 0].double().cpu().numpy()
    for j in range(mt.njnt):
        a, t = mt.jnt_qposadr[j], mt.jnt_type[j]
        if t == 0:                       # free: lower the root
            q[:, a + 2] *= rs.uniform(0.3, 0.8, n)
        elif mt.jnt_limited[j]:
            lo, hi = rng[j]
            q[:, a] = rs.uniform(lo - 0.3, hi + 0.3, n)
        elif t == 2 and abs(axis[j, 2]) > 0.5:
            q[:, a] -= rs.uniform(0.0, 0.3, n)
        elif t == 3:
            q[:, a] += rs.uniform(-0.5, 0.5, n)
    d = pipeline.make_data(m, n)
    d.qpos[:] = env._t(q.T)
    d.qvel[:] = env._t(rs.normal(0, 0.5, (mt.nv, n)))
    return pipeline.forward(m, d)


def loco_reference(torch, dev, convert, registry, id_, state):
    """Phase 50: LOCO_REF_ENVS envs of ``state`` stepped once on the card,
    on the CPU plain path and on it in float64 (env_reference); at the end
    of the run, where the CPU float32 path is itself within TOL of float64
    in every env (a well-conditioned state) the card is held to the CPU
    float32 path within TOL in every env, else to the float64 path by the
    median env (check_reference)."""
    errors = env_reference(torch, dev, convert, registry, id_, state, 1.0,
                           LOCO_REF_ENVS)

    def check():
        errs = errors()
        strict = ("main",) if errs[2].max() <= TOL else ()
        gate = ("every env within TOL of the CPU float32 path" if strict
                else "float64 median gate")
        check_reference(f"{id_} ({gate})", {"main": errs}, LOCO_REF_ENVS,
                        strict=strict)

    CPU_REFS[0].defer(check)


def loco_slice(torch, dev, card, solver, constraint, narrowphase, pipeline,
               convert, registry):
    """Phases 48-53 (the locomotion family: B1 and B2 at nv = 3, 4, 5, 6,
    9, 11 and 23, B1 at nv = 14 past 96 rows); returns the kernels' JSON
    rows."""
    # --- 48. main path and trace
    env, launches, _ = loco_run(torch, dev, card, solver, narrowphase, registry,
                                LOCO_ID, LOCO_B, LOCO_STEPS, LOCO_LIMIT)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def run(k):
        for _ in range(k):
            env.step(torch.rand((LOCO_B, 6), generator=gen, device=dev) * 2 - 1)

    trace(torch, run, 1, card, f"{LOCO_ID} trace", cpu=False,
          counts=lambda: launch_counts(solver, narrowphase))
    print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    runs = {LOCO_ID: (env, launches)}

    # --- 49. the other v5 models x LOCO_B, the legacy IDs x LEGACY_B
    for id_ in LOCO_OTHERS:
        runs[id_] = loco_run(torch, dev, card, solver, narrowphase, registry,
                             id_, LOCO_B, LOCO_OTHER_STEPS, LOCO_OTHER_STEPS - 1,
                             "v5 model")[:2]
    t_phase = time.perf_counter()
    for id_ in LEGACY_IDS:
        loco_run(torch, dev, card, solver, narrowphase, registry, id_, LEGACY_B,
                 LEGACY_STEPS, LEGACY_STEPS - 1, "legacy ID")
    print(f"legacy IDs ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 50. the card against the CPU plain path from each v5 model's state
    for id_, (e, _) in runs.items():
        loco_reference(torch, dev, convert, registry, id_, e.state)

    # --- 51. B1 and B2 at each new nv on random, the main path's and
    # pressed rows
    rows = []
    for id_, name, chol in LOCO_KERNELS:
        t_phase = time.perf_counter()
        e, launched = runs[id_]
        m = e.env.model
        d_main = pipeline.forward(m, e.state.data)
        d_press = loco_pressed(torch, pipeline, e.env, LOCO_B, m.nv)
        n_pen = [int((d.contact.dist < 0).any(dim=0).sum()) if d.contact.dist.numel()
                 else 0 for d in (d_main, d_press)]
        rows += solver_rows(torch, dev, solver, constraint, pipeline, m, d_main,
                            d_press, launched, np.random.RandomState(m.nv),
                            id_, newton_name=name, chol=chol)
        print(f"{id_} kernels (nv = {m.nv}): envs with a penetrating slot "
              f"(main path, pressed) {n_pen} ({time.perf_counter() - t_phase:.1f} s)",
              flush=True)

    # --- 52. make_gym: the per-env path (InvertedPendulum: B6)
    t_phase = time.perf_counter()
    for id_ in LOCO_GYM_IDS:
        genv = registry.make_gym(id_)
        genv.reset(seed=1)
        grng = np.random.default_rng(2)
        zero_counters(solver, narrowphase)
        for _ in range(3):
            obs = genv.step(genv.env.action_low + grng.uniform(0, 1, genv.env.action_dim)
                            * (genv.env.action_high - genv.env.action_low))[0]
            assert obs.shape == (genv.env.obs_dim,) and np.isfinite(obs).all(), id_
        torch.cuda.synchronize()
        got = launch_counts(solver, narrowphase)
        per = loco_launches(genv.env.model, genv.env.cfg.frame_skip,
                            nv2=genv.env.model.nv == 2)
        assert got == per_step(3, **per), (id_, got)
        print(f"single env {id_}: 3 steps, launches {got}", flush=True)
    print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return rows


def kind_row(torch, narrowphase, table, k, ops, out, launches, m, counts, label):
    """The JSON row of kind k alone on ``table`` (GroupTable.only): its rows
    through table_f64_gate on every operand set, timed on the first."""
    sub = table.only([k])
    rel = ab = 0.0
    held = []
    for a in ops:
        r_, b_, h = table_f64_gate(narrowphase, sub, a,
                                   narrowphase.narrowphase(sub, *a))
        rel, ab = max(rel, r_), max(ab, b_)
        held.append(h)
    name = "-".join(GEOMS[t] for t in narrowphase.KINDS[k])
    args = ops[0]
    return kernel_row(
        f"narrowphase_{name.replace('-', '_')}", NP_SRC,
        "gymnasium_robotics_tpu/physics/narrowphase_pallas.py:201",
        launches, ab, rel,
        time_ms(torch, lambda: narrowphase.narrowphase(sub, *args, out=out)),
        time_ms(torch, lambda: narrowphase.narrowphase_plain(sub, *args, out=out),
                n=5),
        narrow_bound(m, sub, args[3], int(sub.rows.numel()), args[0].shape[-1]),
        None, [int(sub.rows.numel()), args[0].shape[-1]],
        envs_penetrating=[counts["main"].get(name, 0), counts["pressed"].get(name, 0)],
        tasks=int(sub.tasks.shape[0]), table=label, held_to_f64_by_set=held,
        note=f"the kind's pairs alone (GroupTable.only) on {label}'s table; "
             "on the main path it runs inside that table's launches")


def fk_sites(torch, dev, kinematics, m, sites):
    """Each FK call site traced on its own, twice: as it is, then after one
    leading elementwise kernel in the same profiling session. Prints the
    fk_kernel launches the wrapper counted beside those each trace holds,
    with the number of narrowphase launches before each fk_kernel event
    (one a forward). ``sites`` maps a name to (the call, the launches it
    must count); the call returns the Data its last FK wrote, whose eleven
    pose fields are held within TOL of the plain version on that Data's
    own qpos and mocap poses, so every counted launch is shown to have
    run whatever the trace keeps. Then FK_BURST launches traced back to
    back."""
    from torch.autograd import DeviceType

    out = {}
    lead = torch.zeros(1, device=dev)
    for name, (fn, expect) in sites.items():
        row = {}
        for label, first in (("alone", None), ("after_lead", lead.add_)):
            torch.cuda.synchronize()
            n0 = kinematics.LAUNCHES["fk"]
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                if first is not None:
                    first(1.0)
                d = fn()
                torch.cuda.synchronize()
            ev = sorted((e.time_range.start, e.name) for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
            fk_at = [sum("narrowphase_kernel" in nm for _, nm in ev[:i])
                     for i, (_, nm) in enumerate(ev) if "fk_kernel" in nm]
            row["counted"] = kinematics.LAUNCHES["fk"] - n0
            assert row["counted"] == expect, (name, row)
            row[f"traced_{label}"] = len(fk_at)
            row[f"narrowphase_before_each_{label}"] = fk_at
            ref = kinematics.kinematics_plain(m, d)
            err = max(rel_err(getattr(d, f), getattr(ref, f))
                      for f in kinematics.FIELDS)
            assert err <= TOL, (name, label, err)
            row["relerr_vs_plain"] = max(row.get("relerr_vs_plain", 0.0), err)
        out[name] = row
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(FK_BURST):
            kinematics.kinematics(m, d)
        torch.cuda.synchronize()
    out[f"{FK_BURST} launches back to back"] = {"traced": sum(
        "fk_kernel" in e.name for e in prof.events()
        if e.device_type == DeviceType.CUDA)}
    print(f"fk sites: {json.dumps(out)}", flush=True)


def fk_step_checks(torch, dev, pipeline, kinematics, convert, m64, fenv,
                   default, level, state, seed):
    """One FK_SEEDS reading: one physics step with the FK kernel, the
    default (pointer-jumping) FK and the level pass, each held on
    FK_REF_ENVS envs to the default path run in float64 on the CPU (the
    kernel path's median env within TOL, its largest env error no more
    than FK_LEVEL_SLACK times the level pass's, or TOL); then one env step
    (20 substeps) with a seeded action, the share of envs within TOL of the
    default-FK step at least FK_STEP_SHARE, the level pass's share printed
    beside it. Returns the readings and the default path's next state."""
    m = fenv.model
    n0 = kinematics.LAUNCHES["fk"]
    d_fk = pipeline.step(m, state.data)
    assert kinematics.LAUNCHES["fk"] == n0 + 1
    d_def = pipeline.step(default.model, state.data)
    d_lvl = pipeline.step(level.model, state.data)
    assert kinematics.LAUNCHES["fk"] == n0 + 1
    d_ref = pipeline.step(m64, envs_f64(convert, state.data, FK_REF_ENVS))
    phys = {}
    for k in ("qpos", "qvel", "qacc"):
        ref = getattr(d_ref, k)
        scale = max(1.0, float(ref.abs().max()))
        errs = [(getattr(d, k)[..., :FK_REF_ENVS].cpu().double() - ref).abs()
                .amax(dim=0) / scale for d in (d_fk, d_def, d_lvl)]
        phys[k] = {name: (float(e.max()), float(e.median()))
                   for name, e in zip(("kernel", "jump", "level"), errs)}
        kmax, kmed = phys[k]["kernel"]
        assert kmed <= TOL, (
            f"fk_kernel, seed {seed}, one physics step, {k}: median env "
            f"relerr {kmed:.3e} against float64 ({phys[k]})")
        assert kmax <= max(TOL, FK_LEVEL_SLACK * phys[k]["level"][0]), (
            f"fk_kernel, seed {seed}, one physics step, {k}: largest env "
            f"relerr {kmax:.3e} against float64, past {FK_LEVEL_SLACK}x the "
            f"level pass's ({phys[k]})")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    a = torch.rand((FETCH_B, 4), generator=gen, device=dev) * 2 - 1
    s_fk = fenv.step(state, a)
    assert kinematics.LAUNCHES["fk"] == n0 + 1 + 21   # no auto-reset here
    s_def = default.step(state, a)
    s_lvl = level.step(state, a)
    scale = max(max(1.0, float(s_def.obs[k].abs().max())) for k in s_def.obs)

    def env_err(s):
        return torch.stack([(s.obs[k] - s_def.obs[k]).abs().amax(dim=1)
                            for k in s.obs]).amax(dim=0).double() / scale

    e_fk, e_lvl = env_err(s_fk), env_err(s_lvl)
    share = float((e_fk <= TOL).double().mean())
    share_lvl = float((e_lvl <= TOL).double().mean())
    assert share >= FK_STEP_SHARE, (
        f"fk_kernel, seed {seed}, one env step: {share:.4f} of envs within "
        f"{TOL} of the default FK (level pass {share_lvl:.4f})")
    return {"seed": seed, "physics_step_vs_f64_max_median": phys,
            "env_step_share_within_tol": {"kernel": share, "level": share_lvl},
            "env_step_relerr_median_max": {
                "kernel": (float(e_fk.median()), float(e_fk.max())),
                "level": (float(e_lvl.median()), float(e_lvl.max()))},
            "next_state": s_def}


def fk_edges(torch, kinematics, m, d):
    """The FK kernel at the edges of its launch against its plain version
    (the level pass), every env within TOL on each field's scale: B = 1, 33
    (a partial tile) and 2047 (the first envs of d), qpos given
    batch-leading (batch stride nq). Returns the largest error."""
    worst = 0.0
    for n in (1, 33, 2047):
        dn = dataclasses.replace(d, qpos=d.qpos[:, :n].T.contiguous().T,
                                 mocap_pos=d.mocap_pos[..., :n],
                                 mocap_quat=d.mocap_quat[..., :n])
        n0 = kinematics.LAUNCHES["fk"]
        got = kinematics.kinematics(m, dn)
        torch.cuda.synchronize()
        assert kinematics.LAUNCHES["fk"] == n0 + 1
        ref = kinematics.kinematics_plain(m, dn)
        for f in kinematics.FIELDS:
            e = rel_err(getattr(got, f), getattr(ref, f))
            assert e <= TOL, f"fk_kernel B={n} {f}: relerr {e:.3e}"
            worst = max(worst, e)
    return worst


def fetchpush_fk(torch, dev, card, solver, constraint, narrowphase,
                 pipeline, kinematics, convert, registry):
    """Phases 15-16; returns the FK kernel's JSON row and (the model it
    ran, the random poses' Data)."""
    t_phase = time.perf_counter()
    # --- 15. main path: FetchPush with Option.fk_kernel=True
    env = registry.make("FetchPush-v4", num_envs=FETCH_B,
                        max_episode_steps=FK_LIMIT)
    env.env.model = env.env.model.with_options(fk_kernel=True)
    obs, info = env.reset(seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    finite = torch.ones(FETCH_B, dtype=torch.bool, device=dev)
    was_reset = torch.zeros(FETCH_B, dtype=torch.bool, device=dev)
    warm = 1
    zero_counters(solver, narrowphase)
    for i in range(FK_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        a = torch.rand((FETCH_B, 4), generator=gen, device=dev) * 2 - 1
        obs, _, terminated, truncated, info = env.step(a)
        finite &= torch.isfinite(obs["observation"]).all(dim=1)
        was_reset |= terminated | truncated
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts(solver, narrowphase)
    n = FK_STEPS
    ms_step = wall / (n - warm) * 1e3
    assert obs["observation"].shape == (FETCH_B, 25), obs["observation"].shape
    assert bool(finite.all()), "non-finite observations"
    assert bool(was_reset.all()), f"{int((~was_reset).sum())} envs never reset"
    assert launches == per_step(n, chol=40, newton=20, topk=40,
                                narrowphase=20, fk=FK_PER_STEP), launches
    print(f"main path: FetchPush-v4 fk_kernel=True x{FETCH_B}, {n} steps, "
          f"limit {FK_LIMIT}, launches {launches} ({FK_PER_STEP} fk a step: "
          f"20 forwards, the gripper refresh, the auto-reset); "
          f"{ms_step:.4f} ms/step, {FETCH_B / ms_step * 1e3:.1f} env-steps/s "
          f"over steps {warm}-{n} [{card}] "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    def run(k):
        for _ in range(k):
            env.step(torch.rand((FETCH_B, 4), generator=gen, device=dev) * 2 - 1)

    trace(torch, run, 1, card, "fk trace", cpu=False,
          counts=lambda: launch_counts(solver, narrowphase),
          window=(env.env, "n_substeps"))
    fenv = env.env
    m = fenv.model
    state = env.state
    a = torch.rand((FETCH_B, 4), generator=gen, device=dev) * 2 - 1

    def env_step():
        env.step(a)
        return env.state.data

    fk_sites(torch, dev, kinematics, m, {
        "forward": (lambda: pipeline.forward(m, state.data), 1),
        "gripper refresh": (lambda: pipeline.refresh_kin(m, state.data), 1),
        "auto-reset state": (lambda: fenv.reset(state, gen).data, 1),
        "env step": (env_step, FK_PER_STEP)})

    # --- 16. FetchPush's float32 solve moves qvel and qacc far, in a few
    # envs, for rounding-sized changes of its input (hence the nv = 21
    # Newton's float64 gate); the FK kernel computes the level pass's
    # operations, so its path is held per env to what the level pass's
    # shows, for FK_SEEDS states: the main path's, then that state after
    # one env step
    t_phase = time.perf_counter()
    default = registry.make("FetchPush-v4")
    assert default.model.opt.fk_kernel is False
    level = registry.make("FetchPush-v4")
    level.model = level.model.with_options(fk_jump=False)
    m64 = registry.make("FetchPush-v4", device="cpu", dtype=torch.float64).model
    readings = []
    s = state
    for seed in FK_SEEDS:
        readings.append(fk_step_checks(torch, dev, pipeline, kinematics,
                                       convert, m64, fenv, default, level,
                                       s, seed))
        s = readings[-1].pop("next_state")
    print(f"fk reference per seed {json.dumps(readings)} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # the kernel against the level pass: the main path's and random poses
    rs = np.random.RandomState(0)
    mt = m.meta
    rand = pipeline.make_data(m, FETCH_B)
    q = m.qpos0[:, 0].cpu().numpy()[:, None] + rs.normal(0, 0.5, (mt.nq, FETCH_B))
    oq = fenv._obj_qadr + 3
    q[oq:oq + 4] = rs.normal(0, 1, (4, FETCH_B))      # unnormalised
    rand.qpos[:] = torch.as_tensor(q, dtype=torch.float32, device=dev)
    rand.mocap_pos[:] = torch.as_tensor(rs.normal(0, 1, (1, 3, FETCH_B)),
                                        dtype=torch.float32, device=dev)
    rand.mocap_quat[:] = torch.as_tensor(rs.normal(0, 1, (1, 4, FETCH_B)),
                                         dtype=torch.float32, device=dev)
    rel = ab = 0.0
    per_field = {}
    for d in (state.data, rand):
        got = kinematics.kinematics(m, d)
        ref = kinematics.kinematics_plain(m, d)
        for f in kinematics.FIELDS:
            g, r = getattr(got, f), getattr(ref, f)
            e = rel_err(g, r)
            per_field[f] = max(per_field.get(f, 0.0), e)
            rel = max(rel, e)
            ab = max(ab, float((g.double() - r.double()).abs().max()))
    assert rel <= TOL, f"fk_kernel: relerr {rel:.3e} {per_field}"
    d = state.data
    fk_ms = time_ms(torch, lambda: kinematics.kinematics(m, d))
    fk_plain_ms = time_ms(torch, lambda: kinematics.kinematics_plain(m, d),
                          n=10)
    edge = fk_edges(torch, kinematics, m, state.data)
    print(f"fk_kernel vs the level pass (main path's and random poses) "
          f"relerr {rel:.3e}, abs {ab:.3e}, per field {per_field}; on the "
          f"main path's poses at B = 1, 33 and 2047 with strided qpos relerr "
          f"{edge:.3e}", flush=True)
    return [kernel_row(
        "fk", FK_SRC,
        "gymnasium_robotics_tpu/physics/kinematics_pallas.py:104",
        launches["fk"], ab, rel, fk_ms, fk_plain_ms, fk_bound(mt, FETCH_B),
        None, [mt.nbody, mt.njnt, mt.ngeom, mt.nsite, FETCH_B])], (m, rand)


def single_env(torch, dev, card, solver, constraint, narrowphase, registry,
               pm_state):
    """Phases 17-20; returns the closed-form Newton's JSON row."""
    # --- 17. main path: the Gymnasium single env on the card
    t_phase = time.perf_counter()
    env = registry.make_gym("PointMaze_UMaze-v3", parity=True)
    assert env.device == dev
    env.reset(seed=0)
    rng = np.random.default_rng(0)
    zero_counters(solver, narrowphase)
    truncs = []
    warm = 10
    for i in range(GYM_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        obs, reward, terminated, truncated, info = env.step(
            rng.uniform(-1, 1, 2))
        truncs.append(truncated)
        assert all(np.isfinite(v).all() for v in obs.values()), "non-finite"
        assert obs["observation"].shape == (4,)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts(solver, narrowphase)
    ms_step = wall / (GYM_STEPS - warm) * 1e3
    assert launches == per_step(GYM_STEPS, chol=2, newton_nv2=1), launches
    assert truncs.index(True) == 299 and all(truncs[299:]), "truncation"
    print(f"main path: make_gym PointMaze_UMaze-v3, {GYM_STEPS} steps, "
          f"launches {launches}; truncated from step 300 on; {ms_step:.4f} "
          f"ms/step over steps {warm}-{GYM_STEPS} [{card}] "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    nv2_launches = launches["newton_nv2"]

    # --- 18. the card against the CPU over 30 steps, into a wall
    t_phase = time.perf_counter()
    env_c = registry.make_gym("PointMaze_UMaze-v3", parity=True, device="cpu")
    env.reset(seed=5)
    env_c.reset(seed=5)
    rs = np.random.RandomState(0)
    err, touched = 0.0, 0
    for _ in range(30):
        a = np.clip(np.array([0.3, -1.0]) + rs.uniform(-0.3, 0.3, 2), -1, 1)
        og, oc = env.step(a)[0], env_c.step(a)[0]
        err = max(err, max(rel_err(torch.as_tensor(og[k]),
                                   torch.as_tensor(oc[k])) for k in og))
        touched += bool(env_c._state.data.qfrc_constraint.abs().max() > 0)
    assert err <= TOL, f"single env, card vs CPU: relerr {err:.3e}"
    assert touched > 0, "the ball never met a wall"
    print(f"single-env reference: card vs CPU, 30 steps, relerr {err:.3e}; "
          f"{touched} steps with constraint forces "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 19. AntMaze and FetchPush through make_gym
    t_phase = time.perf_counter()
    for id_, nu, want in (
            ("AntMaze_UMaze-v5", 8, dict(chol=20, newton=20, topk=40,
                                         narrowphase=20)),
            ("FetchPush-v4", 4, dict(chol=40, newton=20, topk=40,
                                     narrowphase=20))):
        genv = registry.make_gym(id_, parity=True)
        genv.reset(seed=1)
        zero_counters(solver, narrowphase)
        for _ in range(GYM_STEPS_SHORT):
            obs = genv.step(rng.uniform(-1, 1, nu))[0]
            assert all(np.isfinite(v).all() for v in obs.values()), id_
        torch.cuda.synchronize()
        launches = launch_counts(solver, narrowphase)
        assert launches == per_step(GYM_STEPS_SHORT, **want), (id_, launches)
        print(f"single env {id_}: {GYM_STEPS_SHORT} steps, launches {launches}",
              flush=True)
    print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # --- 20. the determinant route against its plain version, B = 8192
    t_phase = time.perf_counter()
    m, d = pm_state
    m = m.with_options(soa=False)
    n_iter = min(m.opt.iterations, 20)
    n_ls = min(m.opt.ls_iterations, 8)
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    ne = J.shape[0]
    real = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    nb = d.qpos.shape[-1]
    rs = np.random.RandomState(5)

    def cuda(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    A = rs.normal(size=(2, 2, nb))
    rand = (cuda(np.einsum("ikb,jkb->ijb", A, A) + 0.1 * np.eye(2)[:, :, None]),
            cuda(rs.normal(size=(2, nb))), cuda(rs.normal(size=(2, nb))),
            cuda(rs.normal(size=(ne, 2, nb))), cuda(rs.normal(size=(ne, nb))),
            cuda(np.exp(rs.normal(size=(ne, nb)))),
            cuda(rs.uniform(size=(ne, nb)) < 0.7, torch.bool),
            cuda(rs.uniform(size=(ne, nb)) < 0.2, torch.bool))
    errs = [newton_vs_f64(torch, solver, x, n_iter, n_ls,
                          solver.solve_newton_nv2, solver.solve_newton_nv2_plain)
            for x in (rand, real)]
    print("newton_nv2 (random, main) against the float64 plain version: "
          "(kernel relerr, float32 plain relerr, kernel vs float32 plain abs "
          f"err) {errs}", flush=True)
    for name, (k, p, _) in zip(("random", "main"), errs):
        assert k <= max(TOL, NEWTON_SLACK * p), (
            f"newton_nv2 ({name}): relerr {k:.3e} against float64, the "
            f"float32 plain version's {p:.3e}")
    ms = time_ms(torch, lambda: solver.solve_newton_nv2(
        *real, n_iter=n_iter, n_ls=n_ls))
    plain_ms = time_ms(torch, lambda: solver.solve_newton_nv2_plain(
        *real, n_iter=n_iter, n_ls=n_ls), n=10)
    bnd = nv2_bound(False, ne, nb, n_iter, n_ls)
    # the single env's own shape: the first env's rows alone
    one = tuple(x[..., :1] if x.dim() > 1 else x for x in real)
    ms_b1 = time_ms(torch, lambda: solver.solve_newton_nv2(
        *one, n_iter=n_iter, n_ls=n_ls))
    b1_bound = nv2_bound(False, ne, 1, n_iter, n_ls)
    n_touching = int(active[1:].any(dim=0).sum())
    print(f"newton_nv2 kernel: {n_touching} of {nb} envs with active wall "
          f"rows, {ne} rows ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)
    return [kernel_row(
        "newton_nv2", SOLVER_SRC,
        "gymnasium_robotics_tpu/physics/solver_pallas.py:42",
        nv2_launches, max(a for _, _, a in errs), max(k for k, _, _ in errs),
        ms, plain_ms, bnd, None, [2, ne, nb, n_iter, n_ls],
        B1={"ms": ms_b1, "bound_ms": b1_bound[0], "bound_by": b1_bound[1]},
        plain32_rel_err=max(p for _, p, _ in errs),
        gate="max_rel_err and plain32_rel_err against the plain version in "
             "float64; max_abs_err against it in float32; max_rel_err <= "
             f"max(tolerance, {NEWTON_SLACK} x plain32_rel_err) per set")]


def ptxas_report(report):
    """{kernel's mangled name: (registers, spill store bytes)} from the
    build's ptxas -v logs (empty for a source found already built)."""
    out, name, spill = {}, None, 0
    for _, log in report.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name, spill = m.group(1), 0
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name] = (int(m.group(1)), spill)
                name = None
    return out


def redesign_fields(rows, ptx, solver, narrowphase, kinematics, tables, fk_model):
    """Registers, spill bytes and blocks per SM of the redesigned kernels'
    rows (topk_select_kernel<KCAP>, newton_tile_kernel<NV, ...>,
    chol_tile_kernel<NV, ...>, narrowphase_kernel, fk_kernel<TE>, and
    newton2_kernel<G, CHOL> on the nv = 2 rows, also for each row count of
    their ``by_ne`` readings); the wrappers' launch geometry is first held
    to the shared memory bytes (and, at nv = 2, the lanes an env) the
    kernels' sources compute. ``tables``: the narrowphase rows' group
    tables by row name; ``fk_model``: the model the FK row ran."""
    nlib, slib, klib = narrowphase._lib(), solver._lib(), kinematics._lib()

    def ptx_of(entry):
        return next((v for k, v in ptx.items() if entry in k), (None, None))

    def nv2_fields(chol, ne, nb):
        geo = solver.newton2_geometry(ne, nb)
        lanes = geo["lanes_per_env"]
        assert lanes == slib.grt_newton2_lanes(ne), (ne, geo)
        regs, spill = ptx_of(f"newton2_kernelILi{lanes}ELb{int(chol)}E")
        assert spill in (0, None), f"newton2_kernel<{lanes}, {chol}>: {spill} bytes of spill"
        return dict(regs=regs, spill_bytes=spill, smem_bytes=geo["smem"],
                    blocks_per_sm=slib.grt_newton2_blocks_per_sm(lanes, int(chol)),
                    grid=geo["grid"], threads=geo["threads"],
                    lanes_per_env=lanes, rows_per_lane=geo["rows_per_lane"])

    for row in rows:
        if row["name"].startswith("topk_select_"):
            G, maxk, nb, K = row["shape"]
            geo = narrowphase.topk_geometry(G, maxk, nb, K)
            assert geo["smem"] == nlib.grt_topk_smem_bytes(maxk, geo["kcap"]), geo
            entry = f"topk_select_kernelILi{geo['kcap']}E"
            blocks = nlib.grt_topk_blocks_per_sm(geo["kcap"], geo["smem"])
        elif (re.fullmatch(r"newton_nv\d+(_r\d+)?", row["name"])
              and row["shape"][0] in solver.NEWTON_TILE_SHAPES):
            nv, ne, nb = row["shape"][:3]
            geo = solver.newton_geometry(nv, ne, nb)
            assert geo["smem"] == slib.grt_newton_smem_bytes(nv, ne), geo
            w, r, e = solver.newton_shape(nv, ne)
            entry = f"newton_tile_kernelILi{nv}ELi{w}ELi{r}ELi{e}E"
            blocks = slib.grt_newton_blocks_per_sm(nv, ne)
            row.update(template=[nv, w, r, e])
        elif row["name"] in [f"chol_solve_nv{nv}" for nv in solver.CHOL_TILE_NV]:
            nv, nb = row["shape"]
            geo = solver.chol_geometry(nv, nb)
            assert geo["smem"] == slib.grt_chol_smem_bytes(nv), geo
            entry = f"chol_tile_kernelILi{nv}E"
            blocks = slib.grt_chol_blocks_per_sm(nv)
        elif row["name"] in tables:
            geo = narrowphase.narrowphase_geometry(tables[row["name"]],
                                                   row["shape"][-1])
            geo["smem"] = 0   # static: the shared scratch, in the ptxas report
            entry = f"narrowphase_kernelILb{int(geo['boxes'])}E"
            blocks = nlib.grt_narrowphase_blocks_per_sm(int(geo["boxes"]))
        elif row["name"] == "fk":
            mt, nb = fk_model.meta, row["shape"][-1]
            geo = kinematics.fk_geometry(mt, nb)
            tabs = fk_model.plan("fk_kernel", kinematics._KernelTables)
            assert geo["smem"] == klib.grt_fk_smem_bytes(tabs.dims), geo
            entry = "fk_kernelEPKf"
            blocks = klib.grt_fk_blocks_per_sm(geo["smem"])
            row.update(tile=geo["tile"], slots=geo["slots"],
                       steps=len(tabs.steps))
        elif row["name"] in ("newton", "newton_nv2"):
            chol = row["name"] == "newton"
            row.update(nv2_fields(chol, *row["shape"][1:3]))
            for reading in row.get("by_ne", {}).values():
                reading.update(nv2_fields(chol, reading["ne"], reading["B"]))
            continue
        else:
            continue
        regs, spill = ptx_of(entry)
        row.update(regs=regs, spill_bytes=spill, blocks_per_sm=blocks,
                   smem_bytes=geo["smem"], grid=geo["grid"],
                   threads=geo["threads"])
        assert spill in (0, None), f"{row['name']}: {spill} bytes of spill"


def edge_checks(torch, dev, solver, narrowphase):
    """Phase 21: the redesigned kernels at the edges of their shapes, each
    against its plain version on the card. topk_select (indices equal): tied
    and +-inf ranks at (2, 744) -> 8 (AntMaze_Large's broadphase) and at
    B = 1 and 2047, and at the hand's (2, 160) -> 16 at B = 1 and 1023;
    K larger than the unmasked count; an all-masked group and a NaN lane
    (also at the hand's shape). The Newton solve (nv = 14 within TOL of
    the float32 plain version; nv = 15, 21, 30, 33 and 36 within max(TOL,
    NEWTON_SLACK x the float32 plain version's error) of the float64 plain
    version): random rows at every instantiation's row cap (96 and 128,
    AntMaze's shape and Ant's; 256, 256, 288, 288, 288) and one under it
    at B = 1, at an ne that is not a multiple of 32, and at 72 rows at a
    B that is not a multiple of the env tile (at
    nv = 36 also the hand's 272 rows, at
    nv = 30 and 33 Door's 278 and Hammer's 275, at B = 1023), with
    n_iter = 0, with every row inactive, and with J in a batch-leading
    layout (the strided staging path)."""
    t_phase = time.perf_counter()
    rs = np.random.RandomState(7)

    def cuda(x):
        x = np.asarray(x)
        return torch.as_tensor(x, dtype=torch.bool if x.dtype == bool
                               else torch.float32, device=dev)

    cases = []
    for (G, maxk), K, nb in (((2, 744), 8, ANT_B), ((2, 169), 24, 1),
                             ((1, 57), 16, 2047), ((2, 216), 8, 2047),
                             ((2, 160), 16, 1), ((2, 160), 16, HAND_B - 1)):
        cases.append((f"ties {G}x{maxk}->{K} B={nb}", *tie_ranks(rs, G, maxk, nb), K))
    rank, mask = tie_ranks(rs, 2, 40, 64)
    mask[:, 5:] = False                       # 5 unmasked rows, K = 16
    cases.append(("K > unmasked", rank, mask, 16))
    rank = rs.normal(size=(3, 85, 96)).astype(np.float32)
    mask = np.ones((3, 85), bool)
    mask[1] = False                           # group 1 all masked
    rank[2, 40, 3] = np.nan                   # an unmasked NaN: lane 3
    rank[0, 7, 5] = np.nan
    mask[0, 7] = False                        # a masked NaN: ignored
    cases.append(("all-masked group, NaN lane", rank, mask, 8))
    rank, mask = tie_ranks(rs, 2, 160, 64)    # the hand's cap, a NaN lane
    mask[1, 145:] = False
    rank[1, 20, 9] = np.nan
    cases.append(("hand 2x160->16, NaN lane", rank, mask, 16))
    for name, rank, mask, K in cases:
        r, mk = cuda(rank), cuda(mask)
        got = narrowphase.topk_select(r, mk, K)
        ref = narrowphase.topk_select_plain(r, mk, K)
        assert torch.equal(got, ref), f"topk_select ({name}): indices differ"
    print(f"edge checks: topk_select equal on {[c[0] for c in cases]}",
          flush=True)

    def rows(nv, ne, nb, p_act=0.6):
        A = rs.normal(size=(nv, nv, nb))
        is_eq = np.zeros(ne, bool)
        is_eq[:6] = True
        return [cuda(np.einsum("ikb,jkb->ijb", A, A) + 0.5 * np.eye(nv)[:, :, None]),
                cuda(rs.normal(size=(nv, nb))), cuda(rs.normal(size=(nv, nb))),
                cuda(rs.normal(size=(ne, nv, nb))), cuda(rs.normal(size=(ne, nb))),
                cuda(np.exp(rs.normal(size=(ne, nb)))),
                cuda(rs.uniform(size=(ne, nb)) < p_act), cuda(is_eq)]

    errs = {}
    for nv, n_iter in ((14, 5), (15, 4), (21, 4), (30, 5), (33, 5), (36, 5)):
        # every instantiation's row cap (nv = 14: AntMaze's 96, Ant's 128)
        caps = [32 * w * r for w, r, _ in solver.NEWTON_TILE_SHAPES[nv]]
        hand = {36: [("hand rows, B % 4 != 0", 272, HAND_B - 1, n_iter, 0.4)],
                30: [("door rows, B % 4 != 0", 278, ADROIT_B - 1, n_iter, 0.4)],
                33: [("hammer rows, B % 4 != 0", 275, ADROIT_B - 1, n_iter, 0.4)]
                }.get(nv, [])
        for name, ne, nb, it, p_act in [
                c for cap in caps for c in (
                    (f"row cap {cap}", cap, ANT_B, n_iter, 0.6),
                    (f"B = 1, cap {cap}", cap - 1, 1, n_iter, 0.6))] + [
                ("ne % 32 != 0", 45, 13, n_iter, 0.6),
                ("B % 8 != 0", 72, 2047, n_iter, 0.6),
                ("n_iter = 0", 72, 64, 0, 0.6),
                ("rows inactive", 72, 64, n_iter, 0.0),
                ("strided J", 72, 64, n_iter, 0.6)] + hand:
            args = rows(nv, ne, nb, p_act)
            if name == "strided J":   # (B, ne, nv) storage: batch stride ne nv
                args[3] = args[3].permute(2, 0, 1).contiguous().permute(1, 2, 0)
            if nv == 14:
                err, _ = check_pair(
                    lambda *a: solver.solve_newton(*a, n_iter=it, n_ls=4),
                    lambda *a: solver.solve_newton_plain(*a, n_iter=it, n_ls=4),
                    (args,))
                assert err <= TOL, f"newton nv=14 ({name}): relerr {err:.3e}"
            else:
                err, p32, _ = newton_vs_f64(torch, solver, args, it, 4)
                assert err <= max(TOL, NEWTON_SLACK * p32), (
                    f"newton nv={nv} ({name}): relerr {err:.3e} against "
                    f"float64, the float32 plain version's {p32:.3e}")
            errs[f"nv{nv} {name} (ne {ne}, B {nb})"] = err
    print(f"edge checks: newton relerr {errs} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)


def chol_edges(torch, dev, solver):
    """Phase 21, the Cholesky kernel (chol_tile_kernel) at nv = 14, 15, 21,
    30, 33 and 36 against its plain version (24 and 29: the cuda tests), within TOL of it on every env and NaN
    where it is NaN: random SPD systems at B = 1, 1023 and 2047, M as a
    transposed
    view (batch stride nv^2) and as a sliced one (every other env of a
    larger batch), b transposed, envs whose factor takes the 1e-20 floor
    exactly (an all-zero M, a diagonal of zeros and ones) and an env with a
    NaN entry."""
    t_phase = time.perf_counter()
    rs = np.random.RandomState(11)
    errs = {}
    for nv in (14, 15, 21, 30, 33, 36):
        def spd(nb):
            A = rs.normal(size=(nv, nv, nb))
            return (np.einsum("ikb,jkb->ijb", A, A)
                    + 0.5 * np.eye(nv)[:, :, None]).astype(np.float32)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        M64 = f32(spd(64))
        M64[:, :, 0] = 0.0                                 # the floor, exactly
        M64[:, :, 1] = torch.diag(torch.arange(nv, device=dev) % 2.0)
        M64[0, 0, 5] = float("nan")
        M2 = f32(spd(4096))
        b = f32(rs.normal(size=(nv, 4096)))
        cases = {
            "B = 1": (f32(spd(1)), f32(rs.normal(size=(nv, 1)))),
            "B = 2047": (f32(spd(2047)), f32(rs.normal(size=(nv, 2047)))),
            "B = 1023": (f32(spd(1023)), f32(rs.normal(size=(nv, 1023)))),
            "transposed M, b": (M2[:, :, :2048].permute(2, 0, 1).contiguous()
                                .permute(1, 2, 0), b[:, :2048].T.contiguous().T),
            "sliced M": (M2[:, :, ::2], b[:, :2048]),
            "floor and NaN envs": (M64, f32(rs.normal(size=(nv, 64)))),
        }
        for name, (M, bb) in cases.items():
            n0 = solver.LAUNCHES["chol"]
            got = solver.solve_pos(M, bb)
            torch.cuda.synchronize()
            assert solver.LAUNCHES["chol"] == n0 + 1
            ref = solver.solve_pos_plain(M, bb)
            if name.startswith("floor"):   # exact arithmetic: equal
                assert torch.equal(got[:, :2], ref[:, :2]), f"chol nv={nv}: floor envs"
                got, ref = got[:, 2:], ref[:, 2:]
            nan = ref.isnan()
            assert bool((got.isnan() == nan).all()), f"chol nv={nv} ({name}): NaN envs differ"
            err = rel_err(got[~nan], ref[~nan])
            assert err <= TOL, f"chol nv={nv} ({name}): relerr {err:.3e}"
            errs[f"nv{nv} {name}"] = err
    print(f"edge checks: chol relerr {errs} ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)


def narrowphase_edges(torch, narrowphase, collision, ctxs):
    """Phase 21, the narrowphase kernel against its plain version (every
    kernel row, as in phase 14; on the pressed Door through table_f64_gate,
    as in phase 37) on the pressed AntMaze, FetchPush, FetchSlide and
    AdroitHandDoor states: at B = 1 and B = 2047 (the first envs), each group kind alone
    (the table cut to it; its rows also bitwise equal to the whole
    table's), with picks out of range on both sides (the kernel clamps
    them) and with int64 picks."""
    t_phase = time.perf_counter()
    errs = {}
    for label, (m, d, hv) in ctxs.items():
        hf = None if hv is None else m.hull_face
        tp = m.plan("pruned", collision._PrunedPlan)
        table = tp.table
        sel = narrowphase.topk_select(collision.broadphase_rank(m, d, tp),
                                      tp.mask, tp.K)
        whole = narrowphase.narrowphase(table, d.geom_xpos, d.geom_xmat,
                                        m.geom_size, sel, hv, hf)
        rs = np.random.RandomState(13)
        wild = torch.as_tensor(rs.randint(-3, tp.mask.shape[1] + 3, tuple(sel.shape)),
                               dtype=torch.int32, device=sel.device)
        cases = [(f"B = {n}", table, d.geom_xpos[..., :n], d.geom_xmat[..., :n],
                  sel[..., :n]) for n in (1, 2047)]
        cases += [(f"kind {k} alone", table.only([k]), d.geom_xpos, d.geom_xmat, sel)
                  for k in sorted({g.kind for g in table.groups})]
        cases += [("picks out of range", table, d.geom_xpos, d.geom_xmat, wild),
                  ("int64 picks", table, d.geom_xpos, d.geom_xmat, sel.long())]
        for name, tab, P, R, sl in cases:
            n0 = narrowphase.LAUNCHES["narrowphase"]
            args = (tab, P, R, m.geom_size, sl, hv, hf)
            got = narrowphase.narrowphase(*args)
            torch.cuda.synchronize()
            assert narrowphase.LAUNCHES["narrowphase"] == n0 + 1
            if label.startswith("Adroit"):   # the pressed fingers' segments
                rel = table_f64_gate(narrowphase, tab, args[1:], got)[0]
            else:
                rel, _ = table_err(got, narrowphase.narrowphase_plain(*args),
                                   tab.rows)
                assert rel <= TOL, f"narrowphase {label} ({name}): relerr {rel:.3e}"
            if name.startswith("kind"):
                assert all(torch.equal(g[tab.rows].view(torch.int32),
                                       w[tab.rows].view(torch.int32))
                           for g, w in zip(got, whole)), f"{label} {name}: bits"
            errs[f"{label} {name}"] = rel
    print(f"edge checks: narrowphase relerr {errs} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)


def maze_rows(torch, dev, constraint, registry, id_, nb):
    """The Newton operands of a PointMaze batch of nb envs reset at seed 0
    and pushed for 25 steps in seeded directions, so balls press into the
    walls: (args, n_iter, n_ls, envs with an active wall row)."""
    env = registry.make(id_, num_envs=nb)
    env.reset(seed=0)
    rs = np.random.RandomState(0)
    dirs = torch.as_tensor(rs.uniform(-1, 1, (nb, 2)), dtype=torch.float32,
                           device=dev)
    for _ in range(25):
        env.step(dirs)
    m, d = env.env.model, env.state.data
    J, aref, D, _, active, is_eq, _ = constraint.build_rows(m, d)
    args = (d.qM, d.qacc_smooth, d.qacc, J, aref, D, active, is_eq)
    return (args, min(m.opt.iterations, 20), min(m.opt.ls_iterations, 8),
            int(active[1:].any(dim=0).sum()))


def nv2_checks(torch, dev, solver, constraint, registry, rows):
    """Phase 21, newton2_kernel on both routes (solve_newton at nv = 2, the
    Cholesky route; solve_newton_nv2, the determinant route) on the rows of
    PointMaze_UMaze-v3 (19, 4 lanes an env), PointMaze_Medium-v3 (39) and
    PointMaze_Large-v3 (63, 8 lanes an env) at B = 8192, balls pushed into
    the walls for 25 steps, each held to its plain version run in float64
    (within TOL, or no further than NEWTON_SLACK times the float32 plain
    version), timed and bounded; the readings go on the nv = 2 rows as
    ``by_ne``."""
    t_phase = time.perf_counter()
    by_row = {r["name"]: r for r in rows}
    for id_ in ("PointMaze_UMaze-v3", "PointMaze_Medium-v3", "PointMaze_Large-v3"):
        args, n_iter, n_ls, n_touching = maze_rows(torch, dev, constraint,
                                                   registry, id_, B)
        ne = args[3].shape[0]
        assert n_touching > 0, f"{id_}: no ball touches a wall"
        for name, kern, plain in (
                ("newton", solver.solve_newton, solver.solve_newton_plain),
                ("newton_nv2", solver.solve_newton_nv2,
                 solver.solve_newton_nv2_plain)):
            k, p, ab = newton_vs_f64(torch, solver, args, n_iter, n_ls, kern, plain)
            assert k <= max(TOL, NEWTON_SLACK * p), (
                f"{name} at {ne} rows ({id_}): relerr {k:.3e} against float64, "
                f"the float32 plain version's {p:.3e}")
            ms = time_ms(torch, lambda: kern(*args, n_iter=n_iter, n_ls=n_ls))
            bnd = nv2_bound(name == "newton", ne, B, n_iter, n_ls)
            by_row[name].setdefault("by_ne", {})[f"ne{ne}"] = {
                "id": id_, "ne": ne, "B": B, "ms": ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "f64_rel_err": k,
                "plain32_f64_rel_err": p, "abs_err_vs_plain32": ab,
                "envs_touching": n_touching}
        print(f"edge checks: nv = 2 at {ne} rows ({id_}): "
              f"{ {n: by_row[n]['by_ne'][f'ne{ne}'] for n in ('newton', 'newton_nv2')} }",
              flush=True)
    print(f"  ({time.perf_counter() - t_phase:.1f} s)", flush=True)


def main():
    import torch

    # The CPU reference paths step batches of 1-64 envs, whose small
    # operators torch's intra-op threads slow down: a FetchPush float64
    # env step of 8 envs took 10.0 s on 8 threads and 3.3 s on one (an
    # 8-core host). The card's path runs no CPU operator that they help.
    torch.set_num_threads(1)
    # --- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)

    from gymnasium_robotics_tpu_torch import convert, kernels, registry
    from gymnasium_robotics_tpu_torch.physics import (
        collision, constraint, kinematics, narrowphase, pipeline, solver)

    dev = torch.device("cuda")
    CPU_REFS.append(CpuRefs())

    # --- 2. build
    t0 = time.perf_counter()
    report = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall", flush=True)
    ptx = ptxas_report(report)
    for name, (secs, log) in report.items():
        print(f"  {name}: {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("   ", line.strip())

    kern, tables = [], {}
    t0 = time.perf_counter()
    rows, pm = pointmaze(torch, dev, card, solver, constraint, narrowphase,
                         convert, registry)
    kern += rows
    print(f"pointmaze phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows, ant = antmaze(torch, dev, card, solver, constraint, narrowphase,
                        collision, pipeline, convert, registry)
    kern += rows
    tables["narrowphase"] = ant[0].plan("pruned", collision._PrunedPlan).table
    print(f"antmaze phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows, fetch = fetchpush(torch, dev, card, solver, constraint, narrowphase,
                            collision, pipeline, convert, registry)
    kern += rows
    tables["narrowphase_fetch"] = fetch[0].plan(
        "pruned", collision._PrunedPlan).table
    print(f"fetchpush phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows, fk = fetchpush_fk(torch, dev, card, solver, constraint, narrowphase,
                            pipeline, kinematics, convert, registry)
    kern += rows
    print(f"fetchpush fk phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    kern += single_env(torch, dev, card, solver, constraint, narrowphase,
                       registry, pm)
    print(f"single-env phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows, _ = handmanipulate(torch, dev, card, solver, constraint, narrowphase,
                             pipeline, convert, registry)
    kern += rows
    print(f"handmanipulate phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows, slide, tabs = fetch_slice(torch, dev, card, solver, constraint,
                                    narrowphase, collision, pipeline, convert,
                                    registry)
    kern += rows
    tables.update(tabs)
    print(f"fetchslide and fetchreach phases: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows, door, tabs = adroit_slice(torch, dev, card, solver, constraint,
                                    narrowphase, collision, pipeline, convert,
                                    registry)
    kern += rows
    tables.update(tabs)
    print(f"adroit phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    kern += reach_slice(torch, dev, card, solver, constraint, narrowphase,
                        pipeline, convert, registry)
    print(f"handreach phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows, tabs = kitchen_slice(torch, dev, card, solver, constraint,
                               narrowphase, collision, pipeline, convert,
                               registry)
    kern += rows
    tables.update(tabs)
    print(f"kitchen phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    kern += loco_slice(torch, dev, card, solver, constraint, narrowphase,
                       pipeline, convert, registry)
    print(f"locomotion phases: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    edge_checks(torch, dev, solver, narrowphase)
    chol_edges(torch, dev, solver)
    narrowphase_edges(torch, narrowphase, collision,
                      {"AntMaze": ant, "FetchPush": fetch, "FetchSlide": slide,
                       "AdroitHandDoor": door})
    nv2_checks(torch, dev, solver, constraint, registry, kern)
    t1 = time.perf_counter()
    edge = fk_edges(torch, kinematics, *fk)
    print(f"edge checks: fk_kernel on random poses at B = 1, 33 and 2047, "
          f"strided qpos: relerr {edge:.3e} ({time.perf_counter() - t1:.1f} s)",
          flush=True)
    print(f"edge checks: {time.perf_counter() - t0:.1f} s", flush=True)
    # --- 53. the reference checks, on the CPU paths' steps
    CPU_REFS[0].run()
    redesign_fields(kern, ptx, solver, narrowphase, kinematics, tables, fk[0])
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for refs in CPU_REFS:
            refs.close()
