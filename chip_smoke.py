#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sbsim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # all phases
    python3 chip_smoke.py --decomposition [DIR] [--envs 1,2,4,8] [--e3]
        # phases 0-1 and the kernels' decomposition; SASS into DIR; K3 at
        # the given block widths; K3/K4 at E=3 six times each
    python3 chip_smoke.py --repeat SECONDS
        # phases 0-1, then phases 5-7 round after round for SECONDS,
        # counting failed parts and empty profiler windows
    python3 chip_smoke.py --ranks N [--backend nccl]
        # phases 0-1, phase 10 with N ranks in (a), phase 11 (b) at 1, 2,
        # ..., N ranks and phase 12 (e) at N ranks; nccl puts rank r on
        # card r (N cards), gloo (the default) all on one card
    python3 chip_smoke.py --graphs [14|15]
        # phases 0-1 and phases 14 and 15 (the captured programs against
        # eager), or the one named
    python3 chip_smoke.py --cluster
        # phases 0-1 and phase 3 (b): the cluster bodies' rows alone
    python3 chip_smoke.py --learn [TRAIN_STEPS] [--out PATH]
        # phases 0-1, tests/test_sac_learning.py's two-zone recipe with its
        # asserts, and the 12-zone sac_sb1_train curve to TRAIN_STEPS
        # (default 12000) with --parity-eval, written to PATH (default
        # artifacts/sac_sb1_12zone_torch_curve.json)

Phases (each prints its own lines; any failure exits non-zero):
  0. CUDA runtime, nvcc and card (name and power limit, from nvidia-smi).
  1. Build the CUDA kernels K1 (fdm_cheby), K2 (fdm_jacobi), K3
     (fdm_jacobi_block) and K4 (fdm_cheby_block) -- launches of the
     Chebyshev and the Jacobi body -- from sbsim_tpu_torch/csrc with nvcc
     for sm_90a.
  2. Each kernel against its plain PyTorch version on the card, at the
     12-zone (B=64, and B=62 for a partial last block of K3/K4) and
     126-room (B=16, 189x124; K3/K4 at E=1) plan shapes, with and without
     fused mix32 convection, with a threefry word plane, with a capped
     iteration limit, and with the zone-statistics epilogue (also with
     windows that need several passes of its scratch plane): fields,
     iteration counts, converged flags and zone/grid sums must be bitwise
     equal; K3/K4 must also equal K2/K1 env for env; K3 and K4 at every E
     their launchers take (1-4 at 12 zones); K2 and K3 with one env's field
     holding a NaN (K2 stops it at iteration 1, K3 runs it to the limit,
     each as its plain version, NaN equal to NaN); K1/K4 on the 9x11
     two-zone grid (columns end in a short run, planes not a multiple of
     16 bytes).
  3. The main paths at full width, sb1_config(num_days_in_episode=2), reset,
     then step_batched: "pallas_cheby" at 12 zones B=2048 and 126 rooms
     B=512 (layout="auto"), "pallas_env" at 12 zones B=2048 (K1, K2 with
     its statistics epilogue); the same in the stack layout
     (pallas_block_mode="stack": K4 and K3, with in-kernel statistics at 12
     zones, the fold at 126 rooms); and the stack config with threefry
     convection (K4 reading the word plane). Launch counts must equal the
     steps; fields and observations finite, rewards in [-1, 0]. Env-steps/s
     from CUDA events; each kernel and its plain version timed alone on the
     path's own inputs, with the bound the card could reach (K1 also with
     statistics and with the word plane; K3/K4 beside K2/K1; K3 and K4 at
     E = 1-4), with its thread blocks resident per SM; and a
     torch.profiler breakdown of 4 more steps (device busy and idle share,
     kernels by device time). (b) A plan above one block's shared memory
     (floor126: 9 x 14 rooms of 50 x 50 cells, 466 x 721) at B=128 through
     "pallas_cheby" and "pallas_env": each step's solve on K1's and K2's
     cluster bodies (one cluster of 8 CTAs an env), launches equal to the
     steps, then each cluster body alone on its path's last-step inputs
     against its kernel's plain version (bitwise), its barriers and tiled
     sub-iterations beside the iterations those its chunk and swap plans
     predict (fdm.swap_groups counting the plan's groups), timed with its
     bound and with the rounds off, and K1's chunk passes timed as the body
     less its run capped at x1 = J(x0). Then the
     decomposition of K1/K4 and K2/K3 at
     12 zones B=2048 and 126 rooms B=512 (K2/K3 also at B=64) on seeded
     inputs: the solve alone, with mix32 swaps, with the word plane, with
     statistics; the cost of one (sub-)iteration (slope over
     iteration_limit 5-33 at threshold -1); registers and spills of each
     instance.
  4. Wiring: 3 steps at 12 zones B=64 through the kernels and through the
     plain versions on the card give bitwise-equal states, in the
     interleaved and stack layouts and with threefry and argsort
     convection.
  5. Training at full width: SACTrainer on sb1_config(num_days_in_episode=2)
     with recipe_for(env, n_envs=64, batch_size=256, replay_capacity=50_000,
     updates_per_env_step=1, seed_steps=0) (examples/train_sac.py's recipe;
     the env step is K2 with in-kernel zone statistics): init, 16
     schedule-table seeding steps (a captured program: its launches are
     those on the device, graphs.py), 32 train_steps, evaluate(n_steps=8,
     n_envs=4); then on the stack config through K3: 8 seeding steps, 8
     train_steps, evaluate(n_steps=4, n_envs=4). Launches must equal the env
     steps taken, the in-kernel zone means must equal the fold bitwise on
     the last state, the losses be finite, alpha have left 1.0 and the
     replay hold a transition per env step. Env-steps/s and SAC updates/s
     from CUDA events, and a torch.profiler split of one train_step into
     its env step and its update. The training kernel at B=64 on the last
     state's inputs: per call and on the device (profiler), its bound and
     blocks per SM; for K3 also K2 on the same inputs and K3 at E = 1-4.
     Then 3 train_steps at n_envs=8 through the kernels and through the
     plain versions on the card: env states and replay contents bitwise
     equal.
  6. Entry points at full width: (a) examples/train_sac.main in-process on
     sb1_config(num_days_in_episode=1), n_envs=64, batch 256: 290
     schedule-table seeding steps (captured programs, as its train steps
     and evaluations; every env reset after the collect step from step
     287 and no other, read off each step's kept output after the run,
     the reset envs bitwise env.reset on that step's reset keys, step_idx
     2 after step 290), 8 train_steps with an evaluation of 16 steps and a
     checkpoint every 4, a final evaluation; the JSONL metrics finite,
     restoring checkpoint 8 gives the final state bitwise, and checkpoint
     4 plus 4 train_steps gives checkpoint 8 bitwise; seeding and
     training env-steps/s from CUDA events. (b) building_suite at 3 x 1365
     envs (BASELINE.json's 4,096), 8 steps through K2 on the three plans
     (grid, env-steps/s and K2 launches per plan), then 3 steps at 3 x 64
     envs through the kernels and through the plain versions, bitwise.
     (c) the 12-zone env with episode_windows=4, 3 steps at B=64 at
     pallas_env and pallas_cheby through the kernels and the plain
     versions, bitwise, more than one window drawn. Launches of (a) and
     of (b)'s 8 steps join the kernels line.
  7. The proto host path (HostEnvironment -> ActionRequest ->
     SimulatedBuilding.request_action / wait_time -> BuildingEnv.step at
     B=1 -> K2, or K1 for fdm_solver="chebyshev" -> observation and reward
     protos -> hourly record shards) with a seeded SAC actor through
     save_policy/load_policy: (a) host12, sb1_config(num_days_in_episode=1),
     30 steps from 07:00 UTC across two hourly shard boundaries, and (e)
     chebyshev12, 4 steps through K1, and (f) host126, the 126-room plan, 6
     steps: each against its run under the plain versions, time steps,
     metrics and every record file bitwise, one launch per step and none on
     the plain run, the shards read back message for message, the episode
     data's cumulative reward the rewards' sum; (b) RealBuildingController,
     8 steps, the proto-assembled observation within 1e-5 of the env's;
     (c) RejectionSimulatedBuilding, the first 2 rewards -inf, the third
     finite; (d) BuildingEnv.step at B=1 from env 5 of a B=64 batch, 3
     steps bitwise row 5 of step_batched. Median ms per HostEnvironment.step
     (CUDA events, all but the first two), split into wait_time and the
     proto and record work, control steps/s, and a torch.profiler window of
     one more step (device busy, idle share, launches), for each of (a),
     (e) and (f).
     Launches of every kernel run join the kernels line.
  8. The offline-learning path on sb1_config(num_days_in_episode=1): (a)
     HostEnvironment over SimulatedBuilding records seeded uniform actions
     from 07:00 UTC through K2 into proto shards, max(144, twice the
     framed features) steps, the first 24 also under the plain versions
     (their record files and framed tables bitwise); the shards framed
     into supervised tables (utils/regression, on utils/frame's Frame),
     every (input, output) pair one step apart; StatsReducer and
     HistogramReducer finite. (b) A float64 ridge fit (alpha 1e-3) on the
     card, one-step zone-temperature error < 0.5 K; a RegressionBuilding
     driven by it over 10 recorded actions within 3 K of the recorded run,
     its reward_info with zones, air handler and boiler; ms per surrogate
     step against ms per simulated step; the run-command predictor's
     setpoint matrix equal to the requests' features (fitted only where
     scikit-learn imports). (c) examples/episode_dashboard.main for a whole
     day (288 steps, one K2 launch each; figures only where matplotlib
     imports), its first 24 steps bitwise the plain run's (zone
     temperatures, energy rates, render_array frames); the base64 PNG of
     BuildingImageGenerator decoded with the standard library to the
     rendered frame; env-steps/s. (d) utils/profiling.device_trace of 4
     dashboard steps names K2; the PhaseTimer report of (a)-(c).
     Launches of (a), (c) and (d) join the kernels line.
  9. The validation path: the port's device path against its exact host
     simulator (envs/exact_host.py: the numpy FDM oracles of
     physics/reference_impl.py, the reference's random streams), each step
     held by exact_host.ParityTracker (max |dT| < 5e-2 K and thermostat
     modes equal, except a threshold crossing by the float32 drift, which
     must come back within 48 steps and before the run ends; the JAX
     package run op by op crosses at the same step, tests/test_torch_opbyop.py):
     (a) parity12,
     sb1_config(num_days_in_episode=1, convection_p=0) with step-function
     occupancy, 288 per-env steps at B=1 through K2 with
     tests/test_device_vs_host.py's boiler, return-water and energy-rate
     gates at step 24; (b) parity12 stack, the same 288 steps through K3
     at B=4 identical envs, the rows bitwise equal, the crossings (a)'s;
     (c) parity126 and (d) shuffle12 run in phase 11; (e) gin12, an env
     from gin text through envs/gin_compat, 3 steps at B=64 through K1
     bitwise the plain versions, and the legacy wiring's host solver; (f)
     the g++ builds of the native libraries, and phase 7's host12 shards
     read by the native scanner equal to a Python framing. Host ms per
     exact-host step beside device ms per step. Launches of (a), (b) and
     (e) join the kernels line.
  10. The distributed path (sbsim_tpu_torch/distributed), its ranks spawned
     processes joined by a FileStore, each with a deadline
     (DIST_TIMEOUT) on the job and on every collective; the ranks report
     their launch counts and times to this process. (a) 2 ranks over gloo
     on this one card (NCCL refuses two ranks on one card; gloo's
     collectives take the CUDA tensors through the host): the train_sac
     recipe at full width (sb1, n_envs=64, 32 per rank, batch 256, replay
     50,000) from PRNGKey(0), 8 schedule-table seeding steps through
     make_distributed_collect_step, then 8 make_shardmapped_train_step
     steps; this process runs one SACTrainer on the same init: the seeded
     states bitwise (env fields, iteration counts, replay), after the
     train steps tests/test_distributed.py's tolerances (reward 1e-5,
     temperatures 1e-4 K, replay rewards 1e-5, parameters 1e-5, log_alpha
     1e-6), sac.step, replay fill, key and env steps equal, every rank's
     metrics equal; K2 launches per rank equal to its steps. Per-rank
     train step ms and the all-reduce ms per update (CUDA events). (d) The
     ranks save a TrainCheckpointer checkpoint at their end (gathered to
     rank 0); restored in this process it is bitwise the gathered state,
     and one more train step resumes from it. (b) The sharded rollout is
     timed warm by the scaling harness in phase 11 (b). (c) A one-rank NCCL
     group: 4 make_distributed_train_step steps bitwise 4
     trainer.train_steps from the same init (state and metrics). Launches
     of the ranks of (a) and (c) join the kernels line.
  11. The scripts beside the package (sbsim_tpu_torch/benchmarks), each
     through its functions, the launch counts set to 0 just before each
     part and read just after: (a) curve12, sac_sb1_train.main at 12 zones
     on a cut recipe (n_envs 64, 150 schedule-table seeding steps, 50
     train steps in chunks of 25, an evaluation of a day at 4 envs every
     25), through K2 (captured programs): its JSON has every key of the
     JAX package's curve (artifacts/sac_sb1_12zone_curve.json), its
     returns finite, and the
     schedule baseline's day through K2 is bitwise its day through the
     plain versions (states and rewards); (b) the scaling harness, 12
     zones pallas_cheby, 1024 envs per rank at 1 and 2 gloo ranks on the
     one card (with --ranks N --backend nccl: 1, 2, ..., N cards): each
     rank one untimed call on a copy of its rows, then 5 calls of 8 steps
     fenced by a barrier and CUDA events; the gathered rows bitwise one
     process's step_batched, K1 launches per rank 6 x 8, env-steps/s best
     and median and the scaling efficiency; (c) parity126,
     fullscale_parity_check.parity_day on the 126-room plan (layout="auto",
     189 x 124, the host reporting it transposed with the geometry's
     diffusers): 288 per-env steps through K2 unstaged beside the exact
     host, no threshold crossing allowed, modes identical every step,
     printed beside the JAX package's 2.197e-3 K; (d) shuffle12, mix32
     swap convection at B=4 for 36 steps against four exact-host runs of
     the reference's shuffle (seeds 100-103) through conv_rounds_sweep's
     run_swap, run_exact and worst_stats: through K2 worst zone KS <= 0.25
     and zone-mean difference <= 0.5 K; through K1 the same statistics
     within 0.02 and 0.01 K of the JAX package's interleaved Chebyshev
     kernel's on the same keys (tests/test_torch_shuffle.py); (e)
     conv_schedule_search on a 2 x 2-room plan (10 CVs a side) with one
     candidate (8 rounds, seed 5, budget 1.0) and --write-cache into a copy
     of the schedule cache, which presets.sb1_config reads back (the
     packaged cache untouched). Any failed gate exits non-zero. Launches of
     (a)-(e) join the kernels line.
  12. The study scripts (sbsim_tpu_torch/benchmarks), each through its
     functions, the launch counts set to 0 just before each part and read
     just after: (a) null126, conv_fullscale_null on the 126-room plan (9 x
     14 rooms, 12 CVs a side): two swap draws at B=4 for 36 steps through K2
     (reset keys from PRNGKey(42) and PRNGKey(1042)), each bitwise its draw
     through the plain versions, and two exact-host runs (seeds 100-103,
     200-203); exact_vs_exact equal to 4 digits to the JAX script's row
     (NULL_EXACT_WITNESS), the three rows printed beside
     artifacts/CONV_FULLSCALE_NULL_r05.json's; (b) designed12,
     conv_designed_sweep's six rows (the seeded 10-round control and the
     five designed schedules) and (c) schedules12, conv_schedule_sweep at
     16:5 and 10:101: each swap run through K2 bitwise the plain versions',
     each row within WITNESS_KS_TOL and WITNESS_DMEAN_TOL of the JAX
     script's (DESIGNED_WITNESS, SCHEDULE_WITNESS); (d) sac_smoke (two
     zones) and sac_sb1_smoke (sb1) on the JAX recipes cut to 30 seeding
     steps, 100 train steps and one evaluation, through K2: every number
     finite, and each smoke's schedule-table rollout through K2 bitwise its
     rollout through the plain versions (states and rewards); (e) the
     scaling decomposition, scaling_decomp at phase 11 (b)'s configuration
     (12 zones pallas_cheby, 1024 envs per rank, 2 gloo ranks on the one
     card; with --ranks N --backend nccl, N cards): five rows of spawned
     ranks, warm, each bitwise one process, K1 launches per rank 6 x 8, the
     rates and the four taxes. Any failed gate exits non-zero. Launches of
     (a)-(e) join the kernels line.
  13. The port bench (sbsim_tpu_torch/bench.py): (a) `python -m
     sbsim_tpu_torch.bench` as a subprocess with a cut budget (BENCH_ARGS)
     at 12 zones (B=2048, pallas_cheby: K1 interleaved) and with
     --full-scale (126 rooms, B=512, K1 unstaged at 189 x 124), (b) with
     --solver pallas_env at 12 zones (K2): each exits 0, its last line has
     the solver, batch and weather asked for, a passed solver check and
     finite positive rates from CUDA events, printed with the card. (c)
     In-process, the bench's make_rollout for 8 steps at each run's config
     and batch from the bench's reset, through the kernels (the captured
     program's first call) and under the plain versions (the rollout op
     by op: they read back): states and mean rewards bitwise equal; (d)
     the same for 32 steps from step 570, across the tables' 592-step end
     (the step tables clamp the step there). Launches of (c) and (d) join
     the kernels line.
  14. The JAX package's jitted programs as CUDA graphs
     (sbsim_tpu_torch/graphs.py), each replay held against the eager call
     from a clone of the same start, under
     torch.cuda.set_sync_debug_mode("error"), with the eager call's
     launches (the launch counts are launches on the device: a capture
     takes back what it counted, a replay adds it): (a) the bench's
     make_rollout at phase 13's three configurations (12 zones B=2048 K1,
     126 rooms B=512 K1 unstaged, 12 zones B=2048 `pallas_env` K2) for 8
     steps from step 0 and 32 from step 570 across the 592-step end,
     bitwise on every state field and the mean reward; then eager against
     graph at the bench's 64-step call (eager, graph, graph, eager; 5
     timed calls each, CUDA events), and one 8-step call of each under
     torch.profiler (device busy, idle share, kernels on the device, the
     host's cudaLaunchKernel and cudaGraphLaunch calls per step), with
     each capture's time and memory pool; (b) the train12 recipe (sb1
     1-day, n_envs 64, batch 256, replay 50,000) from step 286: 4
     schedule-table seeding steps (every env resets inside the second,
     a replay), then 5 train steps through captured_train_step (2 before
     the update gate, 3 after: both sides captured and replayed), each
     call's TrainState and metrics bitwise the eager call's; then 10
     seeding and 10 train steps timed on each path and one train step
     profiled on each; (c) evaluate of a day (288 steps, 4 envs): the
     replay's return bitwise the eager call's; (d) each draw at the main
     paths' shapes (the env step's split and occupancy peeks at B=2048 and
     512, the trainer's split at 64 envs, the actor's normals, the replay's
     indices under a device bound, the threefry word plane) through the
     draw kernel and its plain version on the same card keys, bitwise
     equal, both timed in CUDA graphs beside the draw's bound. Launches of
     (a)-(d) join the kernels line, and (d) gives its rng_draw row.
  15. The rest of the jitted programs as CUDA graphs, each replay held
     against the eager call (the program's `eager`, or the run under
     graphs.disabled()), the replays under
     torch.cuda.set_sync_debug_mode("error"): (a) a one-rank NCCL group
     (a spawned rank), the train12 recipe (n_envs 64, batch 256, replay
     50,000): 5 calls each of make_distributed_collect_step,
     make_distributed_train_step and make_shardmapped_train_step (the
     train steps' update gate opening after 2 of them, both sides captured
     and replayed), every TrainState and metric bitwise the eager call's;
     make_shardmapped_rollout (8 steps) likewise; eager against graph ms
     per call (6 timed calls each) and one call of each profiled
     (kernels on the device, the host's launch calls); (b) a day (288
     steps) of HostEnvironment through the captured per-env step
     (BuildingEnv.captured_step) at host12 (K2), chebyshev12 (K1) and
     host126, time steps, metrics, protos and record files byte-equal to
     the day op by op, HostEnvironment.step and wait_time ms on each path;
     episode_dashboard.main's day bitwise its day op by op;
     fullscale_parity_check.parity_day's first 24 steps at 126 rooms
     likewise; (c) load_policy's captured greedy forward bitwise the eager
     actor on a day's observations, ms per action; (d) phase 11 (a)'s
     sac_sb1_train.main run again op by op, its result equal to the
     captured run's; conv_rounds_sweep's swap step program (its first
     call and 35 replays) bitwise the steps op by op, and run_swap bitwise
     its run op by op, its whole call timed on each path. Launches of
     (a)-(d) join the kernels line.
  16. A {"kernels": [...]} line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

It refuses to run without a CUDA device and never falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"

# Published H100 peaks at the full power limit (NVIDIA data sheets):
# (memory bytes/s, float32 FLOP/s outside the tensor cores).
_PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12), "SXM": (3.35e12, 67e12)}
_PLANS = {
    "12zone": dict(),
    "126room": dict(plan=(9, 14, 12), layout="auto"),
    "12zone_stack": dict(stack=True),
    "126room_stack": dict(plan=(9, 14, 12), layout="auto", stack=True),
    "12zone_threefry": dict(stack=True, conv=dict(rng="threefry")),
    "12zone_argsort": dict(stack=True, conv=dict(method="argsort")),
}
KERNELS = ("fdm_cheby", "fdm_jacobi", "fdm_cheby_block", "fdm_jacobi_block")
# Every launch counter (fdm_cuda.launch_counts): the four kernels and the
# cluster bodies their wrappers launch on a plan that spans blocks.
COUNTED = KERNELS + ("fdm_cheby_cluster", "fdm_jacobi_cluster")
SOLO = {"fdm_cheby_block": "fdm_cheby", "fdm_jacobi_block": "fdm_jacobi"}
REPLACES = {
    "fdm_cheby": "sbsim_tpu/physics/fdm_pallas.py:630",
    "fdm_jacobi": "sbsim_tpu/physics/fdm_pallas.py:207",
    "fdm_cheby_block": "sbsim_tpu/physics/fdm_pallas.py:505",
    "fdm_jacobi_block": "sbsim_tpu/physics/fdm_pallas.py:416",
}
# Phase 3: (label, env, batch, solver, steps). The label names the row of
# the kernels line; the first 12-zone run of each kernel is its row.
MAIN_RUNS = (
    ("12zone", "12zone", 2048, "pallas_cheby", 16),
    ("126room", "126room", 512, "pallas_cheby", 16),
    ("12zone", "12zone", 2048, "pallas_env", 8),
    ("12zone stack", "12zone_stack", 2048, "pallas_cheby", 16),
    ("12zone stack", "12zone_stack", 2048, "pallas_env", 8),
    ("126room stack", "126room_stack", 512, "pallas_cheby", 16),
    ("12zone stack threefry", "12zone_threefry", 2048, "pallas_cheby", 8),
)
# Phase 2: (env, batch) and the cases (convection, iteration limit,
# statistics); convection None, "mix32" (keys) or "words" (threefry plane).
CHECK_SHAPES = (("12zone", 64), ("12zone", 62), ("126room", 16))
CHECK_CASES = ((None, 100, False), ("mix32", 100, False), ("mix32", 3, False),
               (None, 100, True), ("mix32", 100, True), ("words", 100, True))
WIRING = (("12zone", "pallas_cheby"), ("12zone", "pallas_env"),
          ("12zone_stack", "pallas_cheby"), ("12zone_stack", "pallas_env"),
          ("12zone_threefry", "pallas_cheby"), ("12zone_argsort", "pallas_env"))
WIRING_BATCH = 64
# Phase 5: (env, kernel, n_envs, seeding steps, train steps, eval steps).
TRAINING = (("12zone", "fdm_jacobi", 64, 16, 32, 8),
            ("12zone_stack", "fdm_jacobi_block", 64, 8, 8, 4))


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def peaks(name: str):
    for key, value in _PEAKS.items():
        if key in name:
            return key, value
    return "SXM", _PEAKS["SXM"]  # "NVIDIA H100 80GB HBM3" is the SXM part


# Phase 3 (b): (env, batch, steps) of the plan above one block's shared
# memory, built only there, and each main path's (solver, cluster body).
CLUSTER_RUN = ("floor126", 128, 6)
CLUSTER_PATHS = (("pallas_cheby", "fdm_cheby_cluster"), ("pallas_env", "fdm_jacobi_cluster"))
_CLUSTER_PLANS = {"floor126": dict(plan=(9, 14, 50), layout="auto")}


def cluster_phase(max_err, bw, flops, tag):
    """Phase 3 (b): returns ({cluster body: its launches on the main path},
    {cluster body: its kernels-line row})."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.physics import fdm_cuda

    which, batch, steps = CLUSTER_RUN
    dev = torch.device(DEVICE)
    t0 = time.time()
    env = make_env(which, dev)
    geo = fdm_cuda.cluster_geometry(env.geom.shape)
    acts = torch.as_tensor(
        np.random.default_rng(11).uniform(-1, 1, (steps, batch, env.n_actions)),
        dtype=torch.float32, device=dev)
    launches, rows = {}, {}
    for solver, body in CLUSTER_PATHS:
        kname = kernel_of(env, solver)
        state, _ = env.reset(rng.split(rng.PRNGKey(7, device=dev), batch))
        torch.cuda.synchronize()
        fdm_cuda.reset_launch_counts()
        events = []
        for i in range(steps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            state, out = env.step_batched(state, acts[i], solver=solver)
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        counts = dict(fdm_cuda.launch_counts)
        if counts != {k: (steps if k == body else 0) for k in COUNTED}:
            fail(f"{which} {solver}: launch counts {counts} != {steps} {body} launches")
        launches[body] = counts[body]
        if not (torch.isfinite(state.temp).all() and torch.isfinite(out.observation).all()):
            fail(f"{which} {solver}: non-finite field or observation")
        med = statistics.median(s.elapsed_time(e) for s, e in events[2:])
        pre, conv_keys = env._step_pre(state, acts[-1])
        inp = fdm_cuda.kernel_inputs(state.temp, state.input_q, pre["ambient"], pre["h_conv"],
                                     env.coeffs)
        conv = word_conv(env, conv_keys, False)
        limit = env.config.iteration_limit
        plan = fdm_cuda.swap_plan(env.geom.shape, conv.offsets)
        barriers, tiled = (torch.empty(batch, dtype=torch.int32, device=dev) for _ in range(2))
        groups = fdm_cuda.swap_counts["swap_groups"]
        got = run_kernel(kname, env, inp, conv, limit, barriers=barriers, tiled=tiled)
        want = run_kernel(kname, env, inp, conv, limit, plain=True)
        max_err[body] = max(max_err[body], compare(f"{body} at {which} B={batch}", got, want))
        # One cluster barrier an iteration, or a chunk pass (all but x1 =
        # J(x0) tiled), one between groups of the plan, and J(x_f).
        chunk = route_of(env, kname).chunk
        ce = chunk.halo if chunk is not None else 1
        want_tiled = got[1] - 1 if chunk is not None else 0 * got[1]
        planned = len(plan.groups) - 1 + (1 if kname.startswith("fdm_cheby") else 0)
        if not torch.equal(tiled, want_tiled):
            fail(f"{body}: tiled sub-iterations {tiled.tolist()} != {want_tiled.tolist()} "
                 f"(chunk plan {chunk})")
        if not torch.equal(barriers, got[1] - want_tiled + want_tiled // ce + planned):
            fail(f"{body}: barriers {barriers.tolist()} for iterations {got[1].tolist()}, "
                 f"chunk plan {chunk}, swap plan {plan.groups}")
        if fdm_cuda.swap_counts["swap_groups"] != groups + len(plan.groups):
            fail(f"{body}: fdm.swap_groups counted {fdm_cuda.swap_counts['swap_groups'] - groups}"
                 f" for a plan of {len(plan.groups)} groups")
        k_ms = time_call(lambda: run_kernel(kname, env, inp, conv, limit), 10)
        off_ms = time_call(lambda: run_kernel(kname, env, inp, None, limit), 10)
        p_ms = time_call(lambda: run_kernel(kname, env, inp, conv, limit, plain=True), 1)
        b_ms, b_by = bound_ms(inp, conv, got[1], kname, bw, flops)
        fixed = float((barriers - got[1]).double().mean())
        mean_tiled = float(tiled.double().mean())
        print(f" {which} B={batch} {solver} ({env.geom.shape[0]}x{env.geom.shape[1]}, "
              f"clusters of {geo.cluster} CTAs x {geo.threads} threads, {geo.slots} runs a "
              f"thread): {steps} steps, launches {launches[body]}; median step {med:.3f} ms "
              f"-> {batch / med * 1e3:,.0f} env-steps/s; iterations mean "
              f"{float(got[1].float().mean()):.1f}; barriers beside the iterations "
              f"{fixed:.1f} a solve {tag}", flush=True)
        print(f"  {body} ({kname}'s semantics) alone: {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}) -> {b_ms / k_ms:.1%} of bound; rounds off "
              f"{off_ms:.4f} ms, so the {len(conv.offsets)} rounds in {len(plan.groups)} "
              f"group(s) {k_ms - off_ms:.4f} ms {tag}", flush=True)
        rows[body] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, batch=batch,
                          rounds_off_ms=off_ms, swap_groups=len(plan.groups))
        if chunk is not None:
            # The chunk passes: the body less its run capped at x1 = J(x0).
            x1_ms = time_call(lambda: run_kernel(kname, env, inp, conv, 1), 10)
            passes = float(((got[1] - 1) // ce).double().mean())
            print(f"  {body} chunk passes of {ce} ({chunk.th} x {chunk.tw} tiles, "
                  f"{chunk.smem} B): {k_ms - x1_ms:.4f} ms for {passes:.1f} passes "
                  f"({(k_ms - x1_ms) / passes:.4f} ms a pass; capped at x1 {x1_ms:.4f} ms); "
                  f"iterations {float(got[1].double().mean()):.1f}, tiled sub-iterations "
                  f"{mean_tiled:.1f}, barriers {float(barriers.double().mean()):.1f} a solve "
                  f"{tag}", flush=True)
            rows[body].update(chunk_ms=k_ms - x1_ms, chunk_passes=passes,
                              tiled_sweeps=mean_tiled)
    print(f"  phase 3 (b) {time.time() - t0:.1f} s {tag}", flush=True)
    return launches, rows


def make_env(which: str, device):
    from sbsim_tpu_torch.core import geometry
    from sbsim_tpu_torch.envs import building_env, presets

    spec = _PLANS[which] if which in _PLANS else _CLUSTER_PLANS[which]
    kw = {}
    if "plan" in spec:
        nx, ny, cvs = spec["plan"]
        kw = dict(
            floor_plan=geometry.make_synthetic_office_plan(nx, ny, room_cvs=cvs),
            layout=spec["layout"],
        )
    cfg = presets.sb1_config(num_days_in_episode=2, **kw)
    if spec.get("stack"):
        cfg = dataclasses.replace(cfg, pallas_block_mode="stack")
    if "conv" in spec:
        cfg = dataclasses.replace(
            cfg, convection=dataclasses.replace(cfg.convection, **spec["conv"]))
    return building_env.BuildingEnv(cfg, device=device)


def route_of(env, kname: str):
    """The env's route of the solver whose body kernel `kname` runs (its
    solver's arguments, its convection)."""
    return env.route("pallas_cheby" if kname.startswith("fdm_cheby") else "pallas_env")


def block_envs(env, kname: str) -> int:
    """The envs per thread block K3 or K4 (kname) runs for this env's
    config: its route's."""
    return route_of(env, kname).block_envs


def kernel_of(env, solver: str) -> str:
    return env.route(solver).kernel


def word_conv(env, keys, words: bool):
    """Fused swap convection of the env's route from the step keys (mix32
    keys, or the threefry plane of a threefry env), or with `words` the
    threefry word plane of the same keys."""
    from sbsim_tpu_torch.physics import convection, fdm_cuda

    route = env.route("pallas_cheby")
    if not words:
        return route.conv_inputs(keys)
    plane = convection.swap_decision_word(dataclasses.replace(env.convection, rng="threefry"),
                                          keys, env.geom.shape)
    return dataclasses.replace(route.conv, words=fdm_cuda.packed_plane(plane, env.device),
                               word_params=None)


def seeded_inputs(env, batch: int, seed: int, conv_kind):
    """Seeded numpy fields on the card, as kernel inputs + convection."""
    import numpy as np
    import torch
    from sbsim_tpu_torch.physics import fdm_cuda

    rs = np.random.default_rng(seed)
    shape = (batch,) + env.geom.shape
    dev = env.device
    t = lambda a: torch.as_tensor(a, device=dev)
    temp = t((294.0 + rs.normal(0, 2.0, shape)).astype(np.float32))
    q = t(rs.uniform(0.0, 50.0, shape).astype(np.float32))
    t_inf = t(rs.uniform(270.0, 300.0, batch).astype(np.float32))
    h = t(np.full(batch, env.config.weather.convection_coefficient, np.float32))
    keys = rs.integers(0, 2**32, (batch, 2), dtype=np.uint64).astype(np.int64)
    inp = fdm_cuda.kernel_inputs(temp, q, t_inf, h, env.coeffs)
    conv = None if conv_kind is None else word_conv(env, t(keys), conv_kind == "words")
    return inp, conv


def wide_stats(env, seed: int):
    """Statistics with windows too large for one pass of the epilogue's
    scratch plane (12 random-mask zones of 30 x 40 cells on the 52 x 67
    grid, 14,400 cells against 3,484), so it folds them in several passes."""
    import numpy as np
    from sbsim_tpu_torch.physics import gridstats

    rs = np.random.default_rng(seed)
    (h, w), (hc, wc), z = env.geom.shape, (30, 40), 12
    masks = (rs.uniform(size=(z, hc, wc)) < 0.7).astype(np.float32)
    layout = gridstats.ZoneStatLayout(
        masks=masks, sizes=masks.sum(axis=(1, 2)),
        row0=tuple(int(v) for v in rs.integers(0, h - hc + 1, z)),
        col0=tuple(int(v) for v in rs.integers(0, w - wc + 1, z)),
        window=(hc, wc), grid_n=float(h * w))
    return gridstats.ZoneStats(layout, env.device)


def run_kernel(name, env, inp, conv, limit, plain=False, stats=None, e=None, barriers=None,
               tiled=None):
    """Kernel `name` (its plain version with `plain`) on the env's solver
    settings; K3/K4 with `e` envs per thread block (default: the env's);
    `barriers` and `tiled` receive a cluster body's barrier counts and
    tiled sub-iterations."""
    from sbsim_tpu_torch.physics import fdm_cuda

    route = route_of(env, name)
    kw = dict(route.solver_args, iteration_limit=limit, conv=conv, stats=stats)
    if barriers is not None:
        kw.update(barriers=barriers, tiled_sweeps=tiled)
    if name.endswith("_block"):
        kw.update(block_envs=e or route.block_envs)
    fn = getattr(fdm_cuda, f"{name}_plain" if plain else f"{name}_cuda")
    return fn(inp, **kw)


def compare(label, got, want) -> float:
    """Kernel result against the plain version's: field, iteration counts,
    converged flags and, where present, the zone/grid sums, all bitwise."""
    import torch

    (a, ai, ac), (b, bi, bc) = got[:3], want[:3]
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    same = torch.equal(a, b) and torch.equal(ai, bi) and torch.equal(ac, bc)
    note = ""
    if len(got) > 3:
        gs, ws = got[3], want[3]
        sums_same = torch.equal(gs.zone_sums, ws.zone_sums) and torch.equal(
            gs.grid_sums, ws.grid_sums)
        same = same and sums_same
        note = (f" sums ({gs.zone_sums.shape[1]} zones + grid) max|d|="
                f"{float((gs.zone_sums - ws.zone_sums).abs().max()):.3e}")
    print(f"  {label}: max|dT|={err:.3e} iters kernel={ai.tolist()[:6]}"
          f" other={bi.tolist()[:6]} converged={int(ac.sum())}/{ac.numel()}{note}"
          f" {'bitwise equal' if same else 'DIFFERENT'}", flush=True)
    if not same:
        fail(f"{label}: results differ")
    return err


def time_call(fn, reps: int) -> float:
    """Milliseconds per call, CUDA events around `reps` calls after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_TRIES = 3
# Profiler windows opened by device_ms, and those that recorded no FDM kernel.
profile_windows = {"opened": 0, "empty": 0}


def device_ms(fn, reps: int):
    """Milliseconds of device time per call of fn spent in the FDM kernels
    (torch.profiler's kernel events named fdm_*), over `reps` calls after
    one warm-up. At B=64 a kernel takes less time than its wrapper's host
    work, so CUDA events around the calls would time the host. The
    profiler now and then records no device event for a whole window (one
    window in ~150 on the H100); such a window is profiled again, and None
    (not measured) comes back if PROFILE_TRIES windows all saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "fdm_" in e.name)
        profile_windows["opened"] += 1
        if us > 0:
            return us / reps / 1e3
        profile_windows["empty"] += 1
        print(f"  (the profiler recorded no FDM kernel in a window of {reps} calls)", flush=True)
    return None


def fmt_ms(ms) -> str:
    """A device time from device_ms, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f}"


def bound_ms(inp, conv, n_iter, method, bw, flops, stats=None):
    """Least time for the work: each input read once and the output written
    once, or the operations this run's data needed (its iteration counts)
    at the card's peak for their type; the larger of the two.

    Float32: per Jacobi update 4 mul, 4 add, 1 div; per residual sample
    sub, abs, max; per Chebyshev recombination sub, mul, add. Int32 (at
    half the float32 rate): the mix32 word, two fmix32 rounds (6 ops each)
    and 2 xors per plane, and per round a lane extract, compare and the
    two-partner select (7 ops); a word plane instead is read, 4 B per cell
    per env. Statistics epilogue: per env Z * hc * wc mask multiplies and
    about as many adds, H * W adds for the grid sum; the masks and window
    origins read once, B * (Z + 1) sums written."""
    b, h, w = inp.temp.shape
    cells = h * w
    nbytes = 4 * cells * b * 4  # temp, const, denom in; field out
    nbytes += cells * 4 * 5 + cells * 4 * 2  # stencil planes, lead/foll words
    nbytes += b * (4 + 16 + 8)  # tinf, keys, iteration count and flag
    stat_ops = 0.0
    if stats is not None:
        z, hc, wc = stats.masks.shape
        nbytes += z * hc * wc * 4 + z * 8 + b * (z + 1) * 4
        stat_ops = b * (2.0 * z * hc * wc + cells)
    total_iters = float(n_iter.double().sum())
    if method.startswith("fdm_cheby"):
        # sub-iterations (a residual sampled at most every one), plus J(x0)
        # with its residual and the emitted J(x_f)
        f_ops = cells * (15.0 * total_iters + (12.0 + 9.0) * b)
    else:
        f_ops = cells * 12.0 * total_iters
    f_ops += stat_ops
    i_ops = 0.0
    if conv is not None:
        i_ops = cells * b * 7.0 * len(conv.offsets)
        if conv.words is not None:
            nbytes += cells * b * 4
        else:
            i_ops += cells * b * 14.0 * conv.word_params[1]
    t_bytes = nbytes / bw * 1e3
    t_ops = (f_ops / flops + i_ops / (flops / 2)) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def profile_steps(env, state, acts, solver, steps, tag):
    """Device time by kernel over `steps` main-path steps (torch.profiler),
    the device's busy and idle share of the wall time, launches per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _ = env.step_batched(state, acts[i % len(acts)], solver=solver)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"  profile: the profiler saw no device time {tag}", flush=True)
        return
    by_name = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    busy = sum(t for _, t in by_name.values())
    print(f"  profile over {steps} steps: wall {wall_us / steps / 1e3:.3f} ms/step, device busy "
          f"{busy / steps / 1e3:.3f} ms/step ({busy / wall_us:.1%}; idle {1 - busy / wall_us:.1%}), "
          f"{len(kernels) / steps:.0f} kernel launches/step {tag}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for kname, (n, t) in top:
        print(f"    {t / steps / 1e3:8.4f} ms/step {n / steps:6.1f}x  {kname[:90]}", flush=True)


def _tree_diff(a, b):
    """Leaves of two nested numpy dicts that differ (NaN = NaN), with their
    max |difference|."""
    import numpy as np

    flat = lambda d, p="": [(p + k, v) for k, v in d.items() if not isinstance(v, dict)] + [
        x for k, v in d.items() if isinstance(v, dict) for x in flat(v, p + k + "/")]
    fa, fb = dict(flat(a)), dict(flat(b))
    out = [(k, float("nan")) for k in fb if k not in fa]
    for k, x in fa.items():
        y = fb.get(k)
        if y is None or x.shape != y.shape or not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            d = (float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max())
                 if y is not None and x.shape == y.shape and x.size else float("nan"))
            out.append((k, d))
    return out


def _check_equal_trees(label, a, b) -> None:
    diff = _tree_diff(a, b)
    if diff:
        fail(f"{label}: kernel and plain runs differ in {diff}")


class plain_kernels:
    """Within the block, every kernel wrapper runs its plain version, and
    every captured program runs op by op (graphs.disabled: the plain
    versions read the device back, which a graph cannot capture)."""

    def __enter__(self):
        from sbsim_tpu_torch import graphs
        from sbsim_tpu_torch.physics import fdm_cuda

        self.saved = {k: getattr(fdm_cuda, f"{k}_cuda") for k in KERNELS}
        for k in KERNELS:
            setattr(fdm_cuda, f"{k}_cuda", getattr(fdm_cuda, f"{k}_plain"))
        self.eager = graphs.disabled()
        self.eager.__enter__()

    def __exit__(self, *exc):
        from sbsim_tpu_torch.physics import fdm_cuda

        self.eager.__exit__(*exc)
        for k, fn in self.saved.items():
            setattr(fdm_cuda, f"{k}_cuda", fn)


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _open_window():
    """Starts a torch.profiler window over the host and the card."""
    from torch.profiler import ProfilerActivity, profile

    _sync()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True)
    prof.start()
    return prof, time.perf_counter()


def _close_window(window, label, tag) -> None:
    """Ends a window of _open_window; prints its wall time, device busy time
    and launches."""
    import torch

    prof, t0 = window
    _sync()
    wall_us = (time.perf_counter() - t0) * 1e6
    prof.stop()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"    {label}: wall {wall_us / 1e3:.3f} ms, device busy not measured (the "
              f"profiler recorded no device event) {tag}", flush=True)
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"    {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"(idle {1 - busy / wall_us:.1%}), {len(kernels)} kernel launches {tag}", flush=True)


def _profile_window(fn, label, tag):
    """Device busy time and launches of one call of fn (torch.profiler)."""
    window = _open_window()
    out = fn()
    _close_window(window, label, tag)
    return out


def training_phase(env, kname, n_envs, seed_steps, train_steps, eval_steps, max_err,
                   bw, flops, tag) -> int:
    """SACTrainer at full width through kernel `kname` (K2, or K3 in the
    stack layout); returns its launches in the run."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import convert, rng
    from sbsim_tpu_torch.agents import schedule_policy, train
    from sbsim_tpu_torch.physics import fdm_cuda

    label = f"{'stack ' if kname.endswith('_block') else ''}n_envs={n_envs}"
    config = train.recipe_for(env, n_envs=n_envs, batch_size=256, replay_capacity=50_000,
                              updates_per_env_step=1, seed_steps=0)
    trainer = train.SACTrainer(env, config)
    if trainer.env.resolve_solver(n_envs, solver=config.env_solver) != "pallas_env":
        fail("training does not resolve to the pallas_env solver")
    if kernel_of(env, "pallas_env") != kname:
        fail(f"training env steps through {kernel_of(env, 'pallas_env')}, not {kname}")
    state = trainer.init(rng.PRNGKey(0, device=env.device))
    table = schedule_policy.build_schedule_actions(env)
    seed = trainer.seed_with_actions(state, table)
    torch.cuda.synchronize()
    fdm_cuda.reset_launch_counts()
    for _ in range(seed_steps):
        state, _ = seed(state)
    events, metrics = [], []
    for _ in range(train_steps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        state, m = trainer.train_step(state)
        e.record()
        events.append((s, e))
        metrics.append(m)
    ret = trainer.evaluate(state.sac, rng.PRNGKey(1, device=env.device), n_steps=eval_steps,
                           n_envs=4)
    torch.cuda.synchronize()
    counts = dict(fdm_cuda.launch_counts)
    env_steps = seed_steps + train_steps + eval_steps
    if counts != {k: (env_steps if k == kname else 0) for k in COUNTED}:
        fail(f"training {label}: launch counts {counts} != {env_steps} {kname} env steps")
    last = state.env_states
    if not (torch.equal(last.zone_means, env._stats.zone_means(last.temp))
            and torch.equal(last.grid_mean, env._stats.grid_mean(last.temp))):
        fail(f"training {label}: in-kernel zone/grid means differ from the fold")
    losses = torch.stack([torch.stack([m["critic_loss"], m["actor_loss"], m["alpha_loss"]])
                          for m in metrics])
    alpha = float(metrics[-1]["alpha"])
    if not bool(torch.isfinite(losses).all()) or not np.isfinite(float(ret)):
        fail(f"training {label}: non-finite losses or return")
    if alpha == 1.0:
        fail(f"training {label}: alpha never left 1.0")
    if int(state.replay.size) != seed_steps + train_steps or state.env_steps != n_envs * (
            seed_steps + train_steps):
        fail(f"training {label}: replay size {int(state.replay.size)} / env steps "
             f"{state.env_steps}")
    ms = [s.elapsed_time(e) for s, e in events[2:]]
    med = statistics.median(ms)
    total = sum(ms)
    print(f" 12zone {label} batch=256 ({kname}): launches {counts}; {train_steps} "
          f"train_steps, median {med:.3f} ms -> {n_envs / med * 1e3:,.0f} env-steps/s, "
          f"{1e3 / med:,.1f} SAC updates/s (mean over {len(ms)} steps: "
          f"{n_envs * len(ms) / total * 1e3:,.0f} env-steps/s, {len(ms) / total * 1e3:,.1f} "
          f"updates/s); critic loss {float(losses[-1, 0]):.4f}, actor loss "
          f"{float(losses[-1, 1]):.4f}, alpha {alpha:.6f}, eval return {float(ret):.4f}; "
          f"replay {int(state.replay.size)}/env {tag}", flush=True)
    # One train_step split into its env step (collect) and its update.
    print("  profile of one train_step:", flush=True)
    policy = lambda obs, key: trainer.learner.act(state.sac, obs, key)
    state, _ = _profile_window(lambda: trainer.collect_step(state, policy), "env step", tag)
    _profile_window(lambda: trainer.update(state), "SAC update", tag)
    # The kernel alone at the training shape, with the statistics epilogue.
    pre, conv_keys = env._step_pre(
        last, torch.zeros(n_envs, env.n_actions, device=env.device))
    inp = fdm_cuda.kernel_inputs(last.temp, last.input_q, pre["ambient"], pre["h_conv"],
                                 env.coeffs)
    conv = word_conv(env, conv_keys, False)
    limit = env.config.iteration_limit
    got = run_kernel(kname, env, inp, conv, limit, stats=env._stats)
    want = run_kernel(kname, env, inp, conv, limit, plain=True, stats=env._stats)
    max_err[kname] = max(max_err[kname],
                         compare(f"{kname} at training B={n_envs}", got, want))
    run = lambda name, e=None: run_kernel(name, env, inp, conv, limit, stats=env._stats, e=e)
    k_ms = time_call(lambda: run(kname), 20)
    d_ms = device_ms(lambda: run(kname), 20)
    b_ms, b_by = bound_ms(inp, conv, got[1], kname, bw, flops, env._stats)
    e = block_envs(env, kname) if kname in SOLO else 1
    share = "not measured" if d_ms is None else f"{b_ms / d_ms:.1%}"
    print(f"  {kname} alone at B={n_envs}{f' E={e}' if kname in SOLO else ''}: {k_ms:.4f} ms "
          f"per call (CUDA events), {fmt_ms(d_ms)} ms on the device (profiler), bound "
          f"{b_ms:.4f} ms ({b_by}) -> {share} of bound; "
          f"{fdm_cuda.blocks_per_sm(kname, env.geom.shape, e)} blocks per SM, "
          f"{-(-n_envs // e)} blocks {tag}", flush=True)
    if kname in SOLO:
        # K2 on the same inputs, and K3 at every E it takes at this batch.
        solo = run(SOLO[kname])
        if not (torch.equal(solo[0], got[0]) and torch.equal(solo[1], got[1])):
            fail(f"{kname} and {SOLO[kname]} differ at training B={n_envs}")
        sweep = [f"E={ek} {fmt_ms(device_ms(lambda: run(kname, ek), 20))}"
                 for ek in range(1, fdm_cuda.jacobi_max_envs(env.geom.shape) + 1)]
        print(f"  {SOLO[kname]} alone on the same inputs: {time_call(lambda: run(SOLO[kname]), 20):.4f}"
              f" ms per call, {fmt_ms(device_ms(lambda: run(SOLO[kname]), 20))} ms on the device, "
              f"{fdm_cuda.blocks_per_sm(SOLO[kname], env.geom.shape)} blocks per SM; {kname} "
              f"on the device at B={n_envs}: {', '.join(sweep)} ms {tag}", flush=True)

    # Wiring: the same 3 train_steps through the kernels and the plain versions.
    small = train.SACTrainer(env, train.recipe_for(env, n_envs=8, batch_size=64,
                                                   replay_capacity=800, seed_steps=0))
    finals = []
    for plain in (False, True):
        with plain_kernels() if plain else contextlib.nullcontext():
            st = small.init(rng.PRNGKey(2, device=env.device))
            for _ in range(3):
                st, _ = small.train_step(st)
        tree = convert.train_state_to_numpy(st, small)
        finals.append({"env_states": tree["env_states"], "replay": tree["replay"],
                       "sac": tree["sac"]})
    _check_equal_trees(f"training wiring {label}", *finals)
    print(f"  wiring: 3 train_steps at n_envs=8, env states, replay and SAC state bitwise "
          f"equal through {kname} and through its plain version", flush=True)
    return counts[kname]


def ragged_phase(max_err) -> None:
    """K1 and K4 on the 9 x 11 grid of two_zone_test_config: columns end in
    a run of 1 cell and a plane (396 B) is not a multiple of 16 bytes, so
    the threads copy what the bulk engine cannot; B=13, mix32 swap rounds
    on the config's own round, bitwise against the plain versions and K4
    against K1."""
    import numpy as np
    import torch
    from sbsim_tpu_torch.envs import building_env, presets
    from sbsim_tpu_torch.physics import convection, fdm_cuda

    env = building_env.BuildingEnv(presets.two_zone_test_config(), device=DEVICE)
    rs = np.random.default_rng(13)
    batch, shape = 13, env.geom.shape
    t = lambda a: torch.as_tensor(a, device=env.device)
    inp = fdm_cuda.kernel_inputs(
        t((294.0 + rs.normal(0, 2.0, (batch,) + shape)).astype(np.float32)),
        t(rs.uniform(0.0, 50.0, (batch,) + shape).astype(np.float32)),
        t(rs.uniform(270.0, 300.0, batch).astype(np.float32)),
        t(np.full(batch, 100.0, np.float32)), env.coeffs)
    buckets = dataclasses.replace(env.convection, enabled=True, rng="mix32")
    conv = fdm_cuda.ConvInputs(
        offsets=buckets.offsets, lead=fdm_cuda.packed_plane(buckets.lead_words, env.device),
        foll=fdm_cuda.packed_plane(buckets.foll_words, env.device),
        word_params=convection.decision_word_params(buckets),
        keys=t(rs.integers(0, 2**32, (batch, 2), dtype=np.uint64).astype(np.int64)))
    print(f" ragged: grid {shape}, B={batch}, rounds={len(conv.offsets)}", flush=True)
    solo = None
    for kname, e in [("fdm_cheby", None)] + [
            ("fdm_cheby_block", ek) for ek in range(1, fdm_cuda.cheby_max_envs(shape) + 1)]:
        got = run_kernel(kname, env, inp, conv, 100, e=e)
        want = run_kernel(kname, env, inp, conv, 100, plain=True, e=e)
        label = f"{kname}{'' if e is None else f' E={e}'} ragged 9x11"
        max_err[kname] = max(max_err[kname], compare(label, got, want))
        if solo is None:
            solo = got
        else:
            compare(f"{label} vs fdm_cheby", got, solo)


def nan_phase(env, max_err) -> None:
    """One env of B=62 with a NaN in its field: K2 must stop it at iteration
    1 (the solo rule), K3 at each E must run it to the limit (the block
    rule), each bitwise its plain version, NaN equal to NaN."""
    import torch
    from sbsim_tpu_torch.physics import fdm_cuda

    limit = 40
    inp, conv = seeded_inputs(env, 62, seed=14, conv_kind="mix32")
    temp = inp.temp.clone()
    temp[5, 20, 30] = float("nan")
    inp = dataclasses.replace(inp, temp=temp)
    for kname, e in [("fdm_jacobi", None)] + [
            ("fdm_jacobi_block", ek)
            for ek in range(1, fdm_cuda.jacobi_max_envs(env.geom.shape) + 1)]:
        got = run_kernel(kname, env, inp, conv, limit, stats=env._stats, e=e)
        want = run_kernel(kname, env, inp, conv, limit, plain=True, stats=env._stats, e=e)
        torch.cuda.synchronize()
        label = f"{kname}{'' if e is None else f' E={e}'} with a NaN env"
        try:
            for a, b in [*zip(got[:3], want[:3]), (got[3].zone_sums, want[3].zone_sums),
                         (got[3].grid_sums, want[3].grid_sums)]:
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        except AssertionError as exc:
            fail(f"{label}: differs from its plain version: {exc}")
        want_iters = 1 if e is None else limit
        if int(got[1][5]) != want_iters or bool(got[2][5]):
            fail(f"{label}: the NaN env ran {int(got[1][5])} iterations (want "
                 f"{want_iters}), converged {bool(got[2][5])}")
        finite = torch.isfinite(got[0]).flatten(1).all(1)
        print(f"  {label}: NaN env ran {int(got[1][5])} iterations, {int(finite.sum())}/62 "
              f"fields finite, bitwise equal (NaN = NaN) to the plain version", flush=True)
        max_err[kname] = max(max_err[kname], float((got[0] - want[0])[finite].abs().max()))


def check_phase(envs, max_err) -> None:
    """Phase 2: every kernel against its plain version; K3/K4 also against
    K2/K1 env for env; K3/K4 at every E they take; K2/K3 with a NaN env;
    K1/K4 on a ragged grid."""
    from sbsim_tpu_torch.physics import fdm_cuda

    print("phase 2: kernels vs plain versions on the card", flush=True)
    for which, batch in CHECK_SHAPES:
        env = envs[which]
        e = {k: block_envs(env, k) for k in SOLO}
        print(f" {which}: grid {env.geom.shape}, B={batch}, block envs {e}, "
              f"rounds={len(env.convection.offsets)}, rho={env._spectral_radius:.6f}",
              flush=True)
        for kname in KERNELS:
            if kname in SOLO.values() and any(batch % v for v in e.values()):
                continue  # the partial block is K3/K4's case
            for seed, (conv_kind, limit, with_stats) in enumerate(CHECK_CASES):
                inp, conv = seeded_inputs(env, batch, seed=10 * seed + limit, conv_kind=conv_kind)
                stats = env._stats if with_stats else None
                got = run_kernel(kname, env, inp, conv, limit, stats=stats)
                want = run_kernel(kname, env, inp, conv, limit, plain=True, stats=stats)
                label = f"{kname} conv={conv_kind} limit={limit} stats={with_stats}"
                max_err[kname] = max(max_err[kname], compare(label, got, want))
                if kname in SOLO:
                    solo = run_kernel(SOLO[kname], env, inp, conv, limit, stats=stats)
                    compare(f"{label} vs {SOLO[kname]}", got, solo)
                if limit == 3 and bool(got[2].any()):
                    fail(f"{label}: capped solve reported converged")
            if which == "12zone" and batch == 64:
                inp, conv = seeded_inputs(env, batch, seed=9, conv_kind="mix32")
                stats = wide_stats(env, seed=9)
                got = run_kernel(kname, env, inp, conv, 100, stats=stats)
                want = run_kernel(kname, env, inp, conv, 100, plain=True, stats=stats)
                compare(f"{kname} conv=mix32 stats=12 zones of 30x40 (several passes)",
                        got, want)
        if which == "12zone" and batch == 64:
            # K4 and K3 at every E their launchers take on this grid,
            # against K1 and K2.
            inp, conv = seeded_inputs(env, batch, seed=12, conv_kind="mix32")
            for kname, max_envs in (("fdm_cheby_block", fdm_cuda.cheby_max_envs),
                                    ("fdm_jacobi_block", fdm_cuda.jacobi_max_envs)):
                solo = run_kernel(SOLO[kname], env, inp, conv, 100, stats=env._stats)
                for ek in range(1, max_envs(env.geom.shape) + 1):
                    got = run_kernel(kname, env, inp, conv, 100, stats=env._stats, e=ek)
                    want = run_kernel(kname, env, inp, conv, 100, plain=True,
                                      stats=env._stats, e=ek)
                    label = f"{kname} E={ek} conv=mix32 stats=True"
                    max_err[kname] = max(max_err[kname], compare(label, got, want))
                    compare(f"{label} vs {SOLO[kname]}", got, solo)
            nan_phase(env, max_err)
    ragged_phase(max_err)


def main_path_phase(envs, max_err, bw, flops, tag):
    """Phase 3: returns (launches per kernel, timing per (kernel, label))."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.physics import fdm_cuda

    print("phase 3: main paths at full width", flush=True)
    launches = dict.fromkeys(COUNTED, 0)
    timing = {}
    dev = torch.device(DEVICE)
    for label, which, batch, solver, steps in MAIN_RUNS:
        env = envs[which]
        kname = kernel_of(env, solver)
        keys = rng.split(rng.PRNGKey(7, device=dev), batch)
        state, obs = env.reset(keys)
        acts = torch.as_tensor(
            np.random.default_rng(11).uniform(-1, 1, (steps, batch, env.n_actions)),
            dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        fdm_cuda.reset_launch_counts()
        events = []
        rewards = []
        for i in range(steps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            state, out = env.step_batched(state, acts[i], solver=solver)
            e.record()
            events.append((s, e))
            rewards.append(out.reward)
        torch.cuda.synchronize()
        counts = dict(fdm_cuda.launch_counts)
        launches[kname] += counts[kname]
        if counts[kname] != steps or sum(counts.values()) != steps:
            fail(f"{label} {solver}: launch counts {counts} != {steps} steps of {kname}")
        r = torch.stack(rewards)
        if not (torch.isfinite(state.temp).all() and torch.isfinite(out.observation).all()):
            fail(f"{label} {solver}: non-finite field or observation")
        if out.observation.shape != (batch, env.obs_dim) or state.temp.shape != (batch,) + env.geom.shape:
            fail(f"{label} {solver}: unexpected shapes")
        if not (torch.isfinite(r).all() and (r >= -1).all() and (r <= 0).all()):
            fail(f"{label} {solver}: rewards outside [-1, 0]")
        ms = [s.elapsed_time(e) for s, e in events[2:]]  # first two warm up
        med = statistics.median(ms)
        iters = state.fdm_iterations.float()
        fused, with_stats = env.kernel_path(solver)
        e_note = f", {block_envs(env, kname)} envs per block" if kname in SOLO else ""
        print(f" {label} B={batch} {solver} ({kname}{e_note}, conv "
              f"{env.config.convection.method}/{env.config.convection.rng} fused={fused}, "
              f"kernel statistics={with_stats}): {steps} steps, launches {counts}; "
              f"median step {med:.3f} ms -> {batch / med * 1e3:,.0f} env-steps/s; "
              f"iterations mean {float(iters.mean()):.1f} max {int(iters.max())}; "
              f"converged {int(state.fdm_converged.sum())}/{batch}; reward mean "
              f"{float(r.mean()):.4f} {tag}", flush=True)
        # The kernel alone, and its plain version, on this path's own inputs,
        # with the statistics epilogue where the path runs it.
        pre, conv_keys = env._step_pre(state, acts[-1])
        inp = fdm_cuda.kernel_inputs(state.temp, state.input_q, pre["ambient"],
                                     pre["h_conv"], env.coeffs)
        conv = word_conv(env, conv_keys, False) if fused else None
        limit = env.config.iteration_limit
        stats = env._stats if with_stats else None

        def alone(name, st=stats, cv=conv, e=None, note=""):
            got = run_kernel(name, env, inp, cv, limit, stats=st, e=e)
            want = run_kernel(name, env, inp, cv, limit, plain=True, stats=st, e=e)
            err = compare(f"{name}{note} at {label} B={batch} stats={st is not None}", got, want)
            max_err[name] = max(max_err[name], err)
            k_ms = time_call(lambda: run_kernel(name, env, inp, cv, limit, stats=st, e=e), 20)
            p_ms = time_call(
                lambda: run_kernel(name, env, inp, cv, limit, plain=True, stats=st, e=e), 3)
            b_ms, b_by = bound_ms(inp, cv, got[1], name, bw, flops, st)
            occ = fdm_cuda.blocks_per_sm(name, env.geom.shape, e or (
                block_envs(env, name) if name in SOLO else 1))
            print(f"  {name}{note} alone: {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}) -> {b_ms / k_ms:.1%} of bound; {occ} blocks "
                  f"per SM {tag}", flush=True)
            return got, dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                             batch=batch, env_steps_per_s=batch / med * 1e3,
                             blocks_per_sm=occ)

        got, t = alone(kname)
        timing.setdefault((kname, label), t)
        if kname in SOLO:
            # The one-env-per-block kernel on the same inputs, and K3/K4 at
            # every block width they take (12 zones: 1-4).
            solo = run_kernel(SOLO[kname], env, inp, conv, limit, stats=stats)
            compare(f"{kname} vs {SOLO[kname]} at {label} B={batch}", got, solo)
            s_ms = time_call(
                lambda: run_kernel(SOLO[kname], env, inp, conv, limit, stats=stats), 20)
            occ = fdm_cuda.blocks_per_sm(SOLO[kname], env.geom.shape)
            print(f"  {SOLO[kname]} alone on the same inputs: {s_ms:.4f} ms; {occ} blocks "
                  f"per SM {tag}", flush=True)
            if label == "12zone stack":
                max_envs = (fdm_cuda.cheby_max_envs if kname == "fdm_cheby_block"
                            else fdm_cuda.jacobi_max_envs)
                for e in range(1, max_envs(env.geom.shape) + 1):
                    _, te = alone(kname, e=e, note=f" E={e}")
                    timing[(kname, f"{label} E={e}")] = te
        elif kname == "fdm_cheby" and label == "12zone":
            # K1 as the one-env _fdm_cheby_kernel with its statistics
            # epilogue, on the same inputs.
            _, t = alone(kname, st=env._stats, note=" with statistics")
            timing[(kname, f"{label} statistics")] = t
        if label == "12zone stack threefry":
            # K1 reading the same word plane (the interleaved layout).
            _, t = alone("fdm_cheby", st=None, note=" with the word plane")
            timing[("fdm_cheby", f"{label} word plane")] = t
        profile_steps(env, state, acts, solver, 4, tag)
    return launches, timing


def ptxas_usage(log: str):
    """[(entry, registers, spill store bytes, spill load bytes)] per kernel
    instance, from nvcc's -Xptxas -v output."""
    import re

    rows, entry, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((entry, int(m.group(1))) + spill)
            entry = None
    return rows


def sass_loops(sass: str):
    """Per kernel function in `cuobjdump -sass` output: its loops (a branch
    back to an earlier address) as (instructions, opcode histogram)."""
    import re

    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        fname = block.split("\n", 1)[0].strip()
        ins = []
        for line in block.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"(0x[0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                target = int(t.group(1), 16)
                hist = {}
                for a, o, _ in ins:
                    if target <= a <= addr:
                        hist[o.split(".")[0]] = hist.get(o.split(".")[0], 0) + 1
                loops.append((sum(hist.values()), hist))
        out[fname] = sorted(loops, key=lambda x: x[0])
    return out


def sweep_loop(loops, jacobi=False):
    """The sweep among a kernel's loops: the smallest loop with multiplies
    in fives (Chebyshev: four stencil products and omega's per cell update)
    or, with `jacobi`, in fours (the stencil products alone) and at least
    as many adds (the sum and the residual; this keeps out the statistics'
    mask multiply), a shared store and no shuffle (not a reduction);
    returns (instructions, cell updates in its body, histogram) or None."""
    per = 4 if jacobi else 5
    for n, h in loops:
        f = h.get("FMUL", 0)
        if (f >= per and f % per == 0 and h.get("STS") and not h.get("SHFL")
                and (not jacobi or h.get("FADD", 0) >= f)):
            return n, f // per, h
    return None


# Decomposition: (env, batch, kernel family, block envs of its block
# kernel; None for K3's: 1 .. the most it takes, or --envs).
DECOMP_SHAPES = (("12zone", 2048, "cheby", (1, 2, 3, 4)), ("126room", 512, "cheby", (1,)),
                 ("12zone", 2048, "jacobi", None), ("12zone", 64, "jacobi", None),
                 ("126room", 512, "jacobi", (1,)))
DECOMP_LIMITS = (5, 9, 17, 33)


def decomposition(envs, tag, sass_dir=None, jacobi_envs=None) -> None:
    """K1/K4 and K2/K3 on seeded inputs at the main paths' shapes (K2/K3
    also at the trainer's B=64): the solve alone, then with the mix32 swap
    rounds, with the word plane instead, with statistics (12 zones); the
    cost of one (sub-)iteration as the slope of kernel time over
    iteration_limit 5..33 with threshold -1 (every env runs to the limit);
    each instance's registers, spills and resident blocks per SM; with
    `sass_dir`, the SASS of the library and the instructions per cell
    update of each kernel's sweep loop. K3 runs at `jacobi_envs` envs per
    block (default 1 .. fdm_cuda.jacobi_max_envs)."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import buildcache
    from sbsim_tpu_torch.physics import fdm_cuda

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print("decomposition of the FDM kernels", flush=True)
    for entry, regs, st, ld in ptxas_usage(fdm_cuda.build_log):
        print(f"  ptxas {entry}: {regs} registers, spill stores {st} B, loads {ld} B",
              flush=True)
    for which, batch, family, es in DECOMP_SHAPES:
        env = envs[which]
        if es is None:
            es = jacobi_envs or range(1, fdm_cuda.jacobi_max_envs(env.geom.shape) + 1)
        solo = f"fdm_{family}"
        for name, e in [(solo, None)] + [(f"{solo}_block", e) for e in es]:
            label = f"{name}{'' if e is None else f' E={e}'} {which} B={batch}"
            occ = fdm_cuda.blocks_per_sm(name, env.geom.shape, e or 1)
            cases = [("solve only", None, False), ("+ mix32 swaps", "mix32", False),
                     ("+ word plane swaps", "words", False)]
            if env.n_zones <= 12:
                cases += [("+ mix32 swaps + statistics", "mix32", True)]
            parts = []
            for note, kind, with_stats in cases:
                inp, conv = seeded_inputs(env, batch, seed=21, conv_kind=kind)
                st = env._stats if with_stats else None
                run = lambda: run_kernel(name, env, inp, conv, env.config.iteration_limit,
                                         stats=st, e=e)
                iters = run()[1]
                ms = time_call(run, 20)
                parts.append(f"{note} {ms:.4f} ms (iterations mean "
                             f"{float(iters.float().mean()):.2f})")
            inp, _ = seeded_inputs(env, batch, seed=21, conv_kind=None)
            times = []
            for limit in DECOMP_LIMITS:
                kw = dict(route_of(env, name).solver_args, threshold=-1.0,
                          iteration_limit=limit, conv=None)
                if e is not None:
                    kw.update(block_envs=e)
                fn = getattr(fdm_cuda, f"{name}_cuda")
                times.append(time_call(lambda: fn(inp, **kw), 10))
            slope, icpt = np.polyfit(np.array(DECOMP_LIMITS, float), np.array(times), 1)
            # The SMs that hold a block (B=64: 64 of them at one env per block).
            sms = min(n_sm, -(-batch // (e or 1)))
            cells = env.geom.shape[0] * env.geom.shape[1]
            print(f"  {label}: {occ} blocks per SM; " + "; ".join(parts) + "; limit "
                  f"{'/'.join(map(str, DECOMP_LIMITS))} at threshold -1: "
                  f"{'/'.join(f'{t:.4f}' for t in times)} ms -> {slope * 1e3:.2f} us per "
                  f"{'sub-' if family == 'cheby' else ''}iteration "
                  f"({slope * 1e6 * sms / batch / cells:.3f} ns per cell update per busy SM, "
                  f"{sms} SMs), intercept {icpt:.4f} ms {tag}", flush=True)
    if sass_dir:
        os.makedirs(sass_dir, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(buildcache.nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", fdm_cuda.build()], capture_output=True,
                              text=True, check=True).stdout
        with open(os.path.join(sass_dir, "fdm_kernels.sass"), "w") as f:
            f.write(sass)
        for fname, loops in sass_loops(sass).items():
            found = sweep_loop(loops, jacobi="jacobi" in fname)
            if found:
                n, cells, h = found
                top = ", ".join(f"{k} {v}" for k, v in sorted(h.items(), key=lambda kv: -kv[1])[:10])
                print(f"  sass {fname}: sweep loop {n} instructions for {cells} cell updates "
                      f"({n / cells:.1f} per cell update): {top}", flush=True)


def e3_repeats(envs, tag) -> None:
    """K4 and K3 at E=3 with mix32 swaps and statistics on seeded inputs,
    at B=2048 (the last block holds 2 envs) and B=2046 (none partial), six
    times each in turns: 20 calls back to back (time_call, as the
    decomposition times them), and min / median / max of 20 calls each
    timed alone with CUDA events and a synchronise."""
    import torch

    print("K3 and K4 at E=3, six times each", flush=True)
    env = envs["12zone"]
    for batch in (2048, 2046):
        inp, conv = seeded_inputs(env, batch, seed=21, conv_kind="mix32")
        for rep in range(6):
            parts = []
            for name in ("fdm_cheby_block", "fdm_jacobi_block"):
                run = lambda: run_kernel(name, env, inp, conv, env.config.iteration_limit,
                                         stats=env._stats, e=3)
                back = time_call(run, 20)
                ms = []
                for _ in range(20):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    run()
                    b.record()
                    b.synchronize()
                    ms.append(a.elapsed_time(b))
                parts.append(f"{name} back to back {back:.4f} ms, alone {min(ms):.4f} / "
                             f"{statistics.median(ms):.4f} / {max(ms):.4f} ms")
            print(f"  B={batch} run {rep + 1}: " + "; ".join(parts) + f" {tag}", flush=True)


def wiring_phase(envs) -> None:
    """Phase 4: 3 steps through the kernels and through the plain versions."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import convert, rng

    print("phase 4: wiring, kernels vs plain versions through step_batched", flush=True)
    dev = torch.device(DEVICE)
    b = WIRING_BATCH
    for which, solver in WIRING:
        env = envs[which]
        finals = []
        for plain in (False, True):
            with plain_kernels() if plain else contextlib.nullcontext():
                state, _ = env.reset(rng.split(rng.PRNGKey(5, device=dev), b))
                acts = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (3, b, 2)),
                                       dtype=torch.float32, device=dev)
                outs = []
                for i in range(3):
                    state, out = env.step_batched(state, acts[i], solver=solver)
                    outs.append(torch.cat([out.observation, out.reward[:, None]], 1))
            finals.append((convert.env_state_to_numpy(state), torch.stack(outs).cpu().numpy()))
        (sa, oa), (sb, ob) = finals
        _check_equal_trees(f"wiring {which} {solver}", sa, sb)
        if not np.array_equal(oa, ob):
            fail(f"wiring {which} {solver}: kernel and plain runs differ in outputs")
        print(f"  {which} {solver} ({kernel_of(env, solver)}): 3 steps B={b}, states and "
              f"outputs bitwise equal", flush=True)


# Phase 6 (a): examples/train_sac.py on sb1_config(num_days_in_episode=1)
# (288 steps per episode): 18560 // 64 = 290 seeding steps cross every
# env's episode end once.
ENTRY_ARGS = ["--n_envs", "64", "--batch_size", "256", "--replay_capacity", "50000",
              "--seed_episodes_steps", "18560", "--train_steps", "8", "--eval_every", "4",
              "--eval_steps", "16", "--num_days_in_episode", "1"]
SUITE_ENVS = 1365  # BASELINE.json's 4,096 envs as the JAX suite splits them
SUITE_STEPS = 8
WINDOWS = 4


class _Spies:
    """Within the block, the seeding and train steps that train_sac gets
    from distributed/mesh.py (captured programs on the card) are timed with
    CUDA events, and every collect step's input key and output env states
    and observations are kept (each call's outputs are fresh tensors, so
    later steps leave them as they were): the episode end is read off them
    after the run, with no read inside it."""

    def __init__(self):
        self.collects = []  # (rng before, env states after, observations after)
        self.seed_events, self.train_events = [], []

    def __enter__(self):
        import torch
        from sbsim_tpu_torch.distributed import mesh

        names = ("make_distributed_collect_step", "make_distributed_train_step")
        self.saved = {k: getattr(mesh, k) for k in names}
        spies = self

        def spied(make, events):
            def spied_make(*args, **kwargs):
                step = make(*args, **kwargs)

                def call(state):
                    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                        enable_timing=True)
                    s.record()
                    new, metrics = step(state)
                    e.record()
                    events.append((s, e))
                    spies.collects.append((state.rng, new.env_states, new.last_obs))
                    return new, metrics

                return call
            return spied_make

        mesh.make_distributed_collect_step = spied(self.saved[names[0]], self.seed_events)
        mesh.make_distributed_train_step = spied(self.saved[names[1]], self.train_events)
        return self

    def __exit__(self, *exc):
        from sbsim_tpu_torch.distributed import mesh

        for k, fn in self.saved.items():
            setattr(mesh, k, fn)

    def episode_end(self, trainer, episode):
        """(collect steps at which some env was done, whether all were,
        step_idx after each collect step, the differences of the reset
        envs from env.reset on the collect step's reset keys)."""
        import torch
        from sbsim_tpu_torch import convert, rng

        after = [st.step_idx.cpu() for _, st, _ in self.collects]
        before = [torch.zeros_like(after[0])] + after[:-1]
        done = torch.stack([b == episode - 1 for b in before])  # (collect steps, n_envs)
        fired = done.any(1).nonzero().flatten().tolist()
        diffs = []
        for k in fired:
            key, states, obs = self.collects[k]
            _, _, k_reset = rng.split(key, 3)
            fresh, fresh_obs = trainer.env.reset(rng.split(k_reset, trainer.config.n_envs))
            rows = done[k].nonzero().flatten().numpy()
            sel = lambda d: {n: (sel(v) if isinstance(v, dict) else v[rows])
                             for n, v in d.items()}
            diff = _tree_diff(sel(convert.env_state_to_numpy(fresh)),
                              sel(convert.env_state_to_numpy(states)))
            if not torch.equal(fresh_obs[rows], obs[rows]):
                diff.append(("observation", float((fresh_obs[rows] - obs[rows]).abs().max())))
            diffs.append((k + 1, len(rows), diff))
        return fired, bool(done[fired].all()) if fired else False, after, diffs


def _rate(events, per_call) -> str:
    ms = [s.elapsed_time(e) for s, e in events[2:]]
    med = statistics.median(ms)
    return (f"median {med:.3f} ms -> {per_call / med * 1e3:,.0f} env-steps/s (mean over "
            f"{len(ms)}: {per_call * len(ms) / sum(ms) * 1e3:,.0f})")


def entry_train_sac(tag) -> int:
    """Phase 6 (a): train_sac.main in-process through an episode end, with
    its checkpoints, metrics and a resume; returns its K2 launches."""
    import tempfile

    import numpy as np
    import torch
    from sbsim_tpu_torch import convert
    from sbsim_tpu_torch.examples import train_sac
    from sbsim_tpu_torch.io.checkpoint import TrainCheckpointer
    from sbsim_tpu_torch.io.metrics import load_metrics
    from sbsim_tpu_torch.physics import fdm_cuda

    args = train_sac.parse_args(ENTRY_ARGS)
    n_envs, train_steps, eval_steps = args.n_envs, args.train_steps, args.eval_steps
    seed_steps = args.seed_episodes_steps // n_envs
    evals = train_steps // args.eval_every + 1
    with tempfile.TemporaryDirectory() as tmp:
        with _Spies() as spies:
            torch.cuda.synchronize()
            fdm_cuda.reset_launch_counts()
            run = train_sac.main(ENTRY_ARGS + ["--output_dir", tmp])
            torch.cuda.synchronize()
            counts = dict(fdm_cuda.launch_counts)
        env, trainer, state = run.env, run.trainer, run.state
        episode = env.steps_per_episode
        if not episode < seed_steps < 2 * episode:
            fail(f"train_sac: {seed_steps} seeding steps do not cross one {episode}-step end")
        env_steps = seed_steps + train_steps + evals * eval_steps
        if counts != {k: (env_steps if k == "fdm_jacobi" else 0) for k in COUNTED}:
            fail(f"train_sac: launch counts {counts} != {env_steps} fdm_jacobi env steps")
        collects = seed_steps + train_steps
        fired, all_done, step_idx, reset_diffs = spies.episode_end(trainer, episode)
        if len(spies.collects) != collects or fired != [episode - 1] or not all_done:
            fail(f"train_sac: done fired at collect steps {[i + 1 for i in fired]} "
                 f"(all envs: {all_done})")
        after = step_idx[seed_steps - 1]
        if after.tolist() != [seed_steps - episode] * n_envs:
            fail(f"train_sac: step_idx after seeding step {seed_steps} is {after.unique()}")
        if [(at, n) for at, n, _ in reset_diffs] != [(episode, n_envs)] or any(
                d for _, _, d in reset_diffs):
            fail(f"train_sac: the reset envs differ from env.reset: {reset_diffs}")
        cols = load_metrics(os.path.join(tmp, "train_metrics.jsonl"))
        if not cols or not all(np.isfinite(v).all() for v in cols.values()):
            fail(f"train_sac: metrics not finite: {cols}")
        ckpt = TrainCheckpointer(os.path.join(tmp, "ckpt"), trainer)
        mid, last = args.eval_every, train_steps
        if ckpt.steps() != [mid, last]:
            fail(f"train_sac: checkpoints {ckpt.steps()}, want {[mid, last]}")
        final = convert.train_state_to_numpy(state, trainer)
        diff = _tree_diff(convert.train_state_to_numpy(ckpt.restore(state, last), trainer), final)
        if diff:
            fail(f"train_sac: restoring checkpoint {last} differs from the final state in {diff}")
        # Resume: the middle checkpoint and the train_steps after it give
        # the last checkpoint.
        resumed = ckpt.restore(state, mid)
        for _ in range(last - mid):
            resumed, _ = trainer.train_step(resumed)
        diff = _tree_diff(convert.train_state_to_numpy(resumed, trainer), ckpt.read(last))
        if diff:
            fail(f"train_sac: checkpoint {mid} + {last - mid} train_steps differs from "
                 f"checkpoint {last} in {diff}")
    print(f" train_sac.main (sb1 12 zones, n_envs={n_envs}, batch {args.batch_size}, {seed_steps} seeding "
          f"steps across the {episode}-step episode end, {train_steps} train_steps, "
          f"{evals} evaluations of {eval_steps} steps): launches {counts}; done at "
          f"step {episode} for {n_envs}/{n_envs} envs, step_idx {seed_steps - episode}"
          f" after step {seed_steps}, reset envs bitwise env.reset; baseline reward "
          f"{run.baseline_reward:.4f}, final return {run.final_return:.4f}; metrics "
          f"{sorted(cols)} finite; checkpoints {mid} and {last}, restore of {last} bitwise the "
          f"final state, {mid} + {last - mid} train_steps bitwise checkpoint {last} (env states, "
          f"replay, SAC state) {tag}",
          flush=True)
    print(f"  seeding: {_rate(spies.seed_events, n_envs)}; training: "
          f"{_rate(spies.train_events, n_envs)} {tag}", flush=True)
    return counts["fdm_jacobi"]


def entry_suite(max_err, bw, flops, tag) -> int:
    """Phase 6 (b): the 3-building suite at BASELINE.json's 4,096 envs (3 x
    1365) through K2, K2 alone on each plan's inputs of the last step
    (against its plain version, timed, with its bound), then kernels
    against plain versions at 64 per building; returns the K2 launches of
    the 8 steps."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import convert, rng
    from sbsim_tpu_torch.envs import presets, suite as suite_lib
    from sbsim_tpu_torch.physics import fdm_cuda

    dev = torch.device(DEVICE)
    suite = suite_lib.BuildingSuite(presets.building_suite(num_days_in_episode=2), device=dev)
    per_plan = []
    for env in suite.envs:
        shape = env.geom.shape
        if fdm_cuda.run_geometry(shape, 1) is None:
            fail(f"suite plan {shape}: no K2 geometry")
        if kernel_of(env, "pallas_env") != "fdm_jacobi":
            fail(f"suite plan {shape} steps through {kernel_of(env, 'pallas_env')}")
        per_plan.append(dict(env=env, events=[], launches=0))
        real = env.step_batched

        def timed(states, actions, use_pallas=True, solver=None, _real=real,
                  _rec=per_plan[-1]):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            before = fdm_cuda.launch_counts["fdm_jacobi"]
            s.record()
            out = _real(states, actions, use_pallas=use_pallas, solver=solver)
            e.record()
            _rec["events"].append((s, e))
            _rec["launches"] += fdm_cuda.launch_counts["fdm_jacobi"] - before
            return out

        env.step_batched = timed
    states, obs = suite.reset(rng.PRNGKey(3, device=dev), SUITE_ENVS)
    total = SUITE_ENVS * suite.n_buildings
    acts = torch.as_tensor(np.random.default_rng(17).uniform(
        -1, 1, (SUITE_STEPS, total, suite.n_actions)), dtype=torch.float32, device=dev)
    events = []
    torch.cuda.synchronize()
    fdm_cuda.reset_launch_counts()
    for i in range(SUITE_STEPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        states, out = suite.step(states, acts[i])
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    counts = dict(fdm_cuda.launch_counts)
    want = SUITE_STEPS * suite.n_buildings
    if counts != {k: (want if k == "fdm_jacobi" else 0) for k in COUNTED} or any(
            p["launches"] != SUITE_STEPS for p in per_plan):
        fail(f"suite: launch counts {counts}, per plan {[p['launches'] for p in per_plan]}")
    r = out.reward
    if not (out.observation.shape == (total, suite.obs_dim) and torch.isfinite(out.observation).all()
            and all(torch.isfinite(st.temp).all() for st in states)
            and (r >= -1).all() and (r <= 0).all()):
        fail("suite: non-finite fields or observations, or rewards outside [-1, 0]")
    print(f" suite (building_suite, {suite.n_buildings} x {SUITE_ENVS} envs, {SUITE_STEPS} steps "
          f"through fdm_jacobi): launches {counts}; suite step {_rate(events, total)} {tag}",
          flush=True)
    for i, (p, st) in enumerate(zip(per_plan, states)):
        env = p["env"]
        del env.step_batched
        iters = st.fdm_iterations.float()
        geo = fdm_cuda.run_geometry(env.geom.shape, 1)
        print(f"  plan {env.geom.shape} ({env.n_zones} zones; K2 {geo.threads} threads x "
              f"{geo.slots} runs, staged={geo.staged}, {fdm_cuda.blocks_per_sm('fdm_jacobi', env.geom.shape)}"
              f" blocks per SM): K2 launches {p['launches']}; {_rate(p['events'], SUITE_ENVS)}"
              f"; iterations mean {float(iters.mean()):.1f} max {int(iters.max())} {tag}",
              flush=True)
        # K2 alone on this plan's inputs of the last step.
        pre, conv_keys = env._step_pre(st, acts[-1, i * SUITE_ENVS:(i + 1) * SUITE_ENVS])
        inp = fdm_cuda.kernel_inputs(st.temp, st.input_q, pre["ambient"], pre["h_conv"],
                                     env.coeffs)
        fused, with_stats = env.kernel_path("pallas_env")
        conv = word_conv(env, conv_keys, False) if fused else None
        stats = env._stats if with_stats else None
        run = lambda plain=False: run_kernel("fdm_jacobi", env, inp, conv,
                                             env.config.iteration_limit, plain=plain, stats=stats)
        got = run()
        max_err["fdm_jacobi"] = max(max_err["fdm_jacobi"], compare(
            f"fdm_jacobi at suite plan {env.geom.shape} B={SUITE_ENVS} stats={with_stats}",
            got, run(plain=True)))
        k_ms, p_ms = time_call(run, 20), time_call(lambda: run(plain=True), 3)
        b_ms, b_by = bound_ms(inp, conv, got[1], "fdm_jacobi", bw, flops, stats)
        print(f"  fdm_jacobi alone at plan {env.geom.shape} B={SUITE_ENVS}: {k_ms:.4f} ms, plain "
              f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}) -> {b_ms / k_ms:.1%} of bound {tag}",
              flush=True)
    # Kernels against plain versions, 3 steps at 64 envs per building.
    small = torch.as_tensor(np.random.default_rng(18).uniform(
        -1, 1, (3, 64 * suite.n_buildings, suite.n_actions)), dtype=torch.float32, device=dev)
    finals = []
    for plain in (False, True):
        with plain_kernels() if plain else contextlib.nullcontext():
            st, _ = suite.reset(rng.PRNGKey(4, device=dev), 64)
            outs = []
            for i in range(3):
                st, o = suite.step(st, small[i])
                outs.append(torch.cat([o.observation, o.reward[:, None]], 1))
        finals.append(([convert.env_state_to_numpy(x) for x in st],
                       torch.stack(outs).cpu().numpy()))
    (sa, oa), (sb, ob) = finals
    for i, (a, b) in enumerate(zip(sa, sb)):
        _check_equal_trees(f"suite plan {i}", a, b)
    if not np.array_equal(oa, ob):
        fail("suite: kernel and plain runs differ in outputs")
    print(f"  suite 3 steps at 3 x 64 envs: fields, iteration counts and observations bitwise "
          f"equal through fdm_jacobi and its plain version", flush=True)
    return counts["fdm_jacobi"]


def entry_windows(tag) -> None:
    """Phase 6 (c): the 12-zone env with episode_windows=4, 3 steps at
    B=64 through pallas_env and pallas_cheby, kernels against plain
    versions."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import convert, rng
    from sbsim_tpu_torch.envs import building_env, presets
    from sbsim_tpu_torch.physics import fdm_cuda

    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(presets.sb1_config(num_days_in_episode=2), episode_windows=WINDOWS)
    env = building_env.BuildingEnv(cfg, device=dev)
    b = WIRING_BATCH
    acts = torch.as_tensor(np.random.default_rng(6).uniform(-1, 1, (3, b, env.n_actions)),
                           dtype=torch.float32, device=dev)
    for solver in ("pallas_env", "pallas_cheby"):
        kname = kernel_of(env, solver)
        finals = []
        for plain in (False, True):
            with plain_kernels() if plain else contextlib.nullcontext():
                state, _ = env.reset(rng.split(rng.PRNGKey(8, device=dev), b))
                fdm_cuda.reset_launch_counts()
                outs = []
                for i in range(3):
                    state, out = env.step_batched(state, acts[i], solver=solver)
                    outs.append(torch.cat([out.observation, out.reward[:, None]], 1))
                counts = dict(fdm_cuda.launch_counts)
            if counts[kname] != (0 if plain else 3) or sum(counts.values()) != counts[kname]:
                fail(f"windows {solver}: launch counts {counts} (plain={plain})")
            finals.append((convert.env_state_to_numpy(state), torch.stack(outs).cpu().numpy()))
        (sa, oa), (sb, ob) = finals
        _check_equal_trees(f"windows {solver}", sa, sb)
        if not np.array_equal(oa, ob):
            fail(f"windows {solver}: kernel and plain runs differ in outputs")
        drawn = np.unique(sa["window"])
        if len(drawn) < 2:
            fail(f"windows {solver}: only window(s) {drawn} drawn")
        print(f"  windows ({WINDOWS} windows, B={b}) {solver} ({kname}): 3 steps, windows "
              f"{drawn.tolist()} drawn, states and outputs bitwise equal to the plain "
              f"version {tag}", flush=True)


# Phase 7: the proto host path. host12 runs HOST_STEPS control steps from
# 07:00 UTC, across two hourly shard boundaries; the 126-room plan fewer.
HOST_STEPS = 30
CONTROLLER_STEPS = 8
REJECTIONS = 2
ROW_STEPS = 3
ROW = 5
CHEBY_STEPS = 4
HOST126_STEPS = 6
RECORD_WRITES = ("write_action_response", "write_observation_response", "write_reward_info",
                 "write_reward_response")
RECORD_READS = ("read_action_responses", "read_observation_responses", "read_reward_infos",
                "read_reward_responses")
# The record files of each host path's kernel run, by label (phase 9 (f)
# reads host12's again).
HOST_SHARDS = {}


def host_policy(env, seed, directory):
    """The greedy actor of a seeded SAC learner, through save_policy and
    load_policy, as a deployed policy reaches a building."""
    import torch
    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.agents import policies, sac

    learner = sac.SACLearner(env.obs_dim, env.n_actions, device=env.device)
    policies.save_policy(directory, learner, learner.init(rng.PRNGKey(seed, device=env.device)),
                         env.action_names)
    policy, _ = policies.load_policy(directory, device=env.device)
    return lambda obs: policy(torch.as_tensor(obs[None], device=env.device))[0].cpu().numpy()


def host_run(env, policy, steps, plain, eager=False, read_back=True):
    """HostEnvironment over SimulatedBuilding(env, seed=0) recording into a
    temporary directory: reset, then `steps` control steps with the policy's
    actions, through the kernels or (with `plain`) their plain versions;
    with `eager` the captured programs (the per-env step, the policy) run
    op by op. Returns the time steps, the metrics, the record files by
    name, the messages written, the episode data and the messages read
    back (unless not `read_back`), the launch counts and the CUDA events of
    each step and of its wait_time."""
    import tempfile

    import torch
    from sbsim_tpu_torch import graphs
    from sbsim_tpu_torch.envs import host_adapter, host_environment
    from sbsim_tpu_torch.io import records
    from sbsim_tpu_torch.physics import fdm_cuda

    event = lambda: torch.cuda.Event(enable_timing=True)
    written, saved = [], {k: getattr(records.RecordWriter, k) for k in RECORD_WRITES}

    def spy(name):
        def write(writer, msg, timestamp):
            written.append((name, msg))
            return saved[name](writer, msg, timestamp)
        return write

    with tempfile.TemporaryDirectory() as tmp, (
            plain_kernels() if plain else contextlib.nullcontext()), (
            graphs.disabled() if eager else contextlib.nullcontext()):
        for k in RECORD_WRITES:
            setattr(records.RecordWriter, k, spy(k))
        try:
            building = host_adapter.SimulatedBuilding(env, seed=0)
            host = host_environment.HostEnvironment(building, env, metrics_path=tmp)
            wait_events, step_events = [], []
            real_wait = building.wait_time

            def timed_wait():
                s, e = event(), event()
                s.record()
                real_wait()
                e.record()
                wait_events.append((s, e))

            building.wait_time = timed_wait
            first = host.reset()
            steps_out = [first]
            torch.cuda.synchronize()
            fdm_cuda.reset_launch_counts()
            for _ in range(steps):
                action = policy(steps_out[-1].observation)
                s, e = event(), event()
                s.record()
                steps_out.append(host.step(action))
                e.record()
                step_events.append((s, e))
            torch.cuda.synchronize()
            counts = dict(fdm_cuda.launch_counts)
        finally:
            for k, fn in saved.items():
                setattr(records.RecordWriter, k, fn)
        (episode,) = os.listdir(tmp)
        folder = os.path.join(tmp, episode)
        files = {name: open(os.path.join(folder, name), "rb").read()
                 for name in sorted(os.listdir(folder))}
        read = data = None
        if read_back:
            reader = records.RecordReader(folder)
            read = {r: getattr(reader, r)() for r in RECORD_READS}
            data = records.get_episode_data(tmp)
    return dict(steps=steps_out, metrics=host.metrics, files=files, written=written, read=read,
                data=data, counts=counts, building=building, step_events=step_events,
                wait_events=wait_events)


def _same_metrics(a, b) -> bool:
    import numpy as np

    if sorted(a) != sorted(b):
        return False
    for k, x in a.items():
        y = b[k]
        if isinstance(x, dict):
            if not _same_metrics(x, y):
                return False
        elif k == "timestamps":
            if x != y:
                return False
        elif not np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True):
            return False
    return True


def host_check(label, env, policy, steps, kname, tag):
    """One host path through the kernel and through its plain version:
    every time step, the metrics and every record file bitwise equal; the
    kernel launched once per step on the kernel run and never on the plain
    run; the shards read back, message for message; the episode data's
    cumulative reward the sum of the rewards. Prints the step rates; returns
    the kernel run's launches of `kname`."""
    import tempfile

    import numpy as np
    from sbsim_tpu_torch.envs import host_adapter, host_environment

    got, want = host_run(env, policy, steps, plain=False), host_run(env, policy, steps, plain=True)
    if got["counts"] != {k: (steps if k == kname else 0) for k in COUNTED} or any(
            want["counts"].values()):
        fail(f"{label}: launch counts {got['counts']}, plain run {want['counts']}")
    for i, (a, b) in enumerate(zip(got["steps"], want["steps"], strict=True)):
        if (a.step_type, a.discount) != (b.step_type, b.discount) or not np.array_equal(
                [a.reward], [b.reward]) or not np.array_equal(a.observation, b.observation):
            fail(f"{label}: time step {i} differs from the plain run")
    if not _same_metrics(got["metrics"], want["metrics"]):
        fail(f"{label}: the metrics timeseries differ from the plain run")
    if list(got["files"]) != list(want["files"]) or any(
            got["files"][k] != want["files"][k] for k in got["files"]):
        diff = sorted(k for k in set(got["files"]) | set(want["files"])
                      if got["files"].get(k) != want["files"].get(k))
        fail(f"{label}: record files differ from the plain run: {diff}")
    for write, read in zip(RECORD_WRITES, RECORD_READS):
        mine = [m for name, m in got["written"] if name == write]
        back = got["read"][read]
        if len(mine) != steps or len(back) != steps or any(x != y for x, y in zip(mine, back)):
            fail(f"{label}: {read} read back {len(back)} messages for {len(mine)} written "
                 f"(of {steps} steps), or they differ")
    rewards = [ts.reward for ts in got["steps"][1:]]
    if list(got["data"]["n_steps"]) != [steps] or got["data"]["cumulative_reward"][0] != sum(
            float(np.float32(r)) for r in rewards):
        fail(f"{label}: episode data {got['data']} against rewards summing to {sum(rewards)}")
    info = got["building"].reward_info
    if len(info.zone_reward_infos) != env.n_zones:
        fail(f"{label}: reward_info holds {len(info.zone_reward_infos)} zones of {env.n_zones}")
    shards = sorted({name.rsplit("_", 1)[1] for name in got["files"] if name[-3] == "."})
    print(f"  {label} ({env.n_zones} zones, {env.geom.shape[0]} x {env.geom.shape[1]}; "
          f"{steps} HostEnvironment steps through {kname}): launches {got['counts'][kname]} "
          f"(plain run 0); time steps, metrics and {len(got['files'])} record files "
          f"({', '.join(shards)}) bitwise equal to the plain run; {steps} messages of each "
          f"per-step type read back equal; cumulative reward "
          f"{got['data']['cumulative_reward'][0]:.6f}", flush=True)
    ms = [s.elapsed_time(e) for s, e in got["step_events"][2:]]
    wait = [s.elapsed_time(e) for s, e in got["wait_events"][2:]]
    rest = [a - b for a, b in zip(ms, wait)]
    med = statistics.median(ms)
    print(f"  {label} rates: HostEnvironment.step median {med:.3f} ms over {len(ms)} steps "
          f"(wait_time {statistics.median(wait):.3f} ms, proto and record work "
          f"{statistics.median(rest):.3f} ms) -> {1e3 / med:.1f} control steps/s; plain run "
          f"{statistics.median(s.elapsed_time(e) for s, e in want['step_events'][2:]):.3f} ms "
          f"{tag}", flush=True)
    # Device busy and launches of one more step, on a fresh building.
    with tempfile.TemporaryDirectory() as tmp:
        host = host_environment.HostEnvironment(host_adapter.SimulatedBuilding(env, seed=0), env,
                                                metrics_path=tmp)
        ts = host.step(policy(host.reset().observation))
        _profile_window(lambda: host.step(policy(ts.observation)),
                        f"{label} profile of one HostEnvironment.step", tag)
    HOST_SHARDS[label] = got["files"]
    return got["counts"][kname]


def host_phase(envs, tag) -> dict:
    """Phase 7: the proto host path on the card; returns the launches of
    K2 and K1 of its kernel runs."""
    import tempfile

    import numpy as np
    import torch
    from sbsim_tpu_torch import convert, rng
    from sbsim_tpu_torch.envs import building_env, host_adapter, host_environment, presets
    from sbsim_tpu_torch.envs import real_building
    from sbsim_tpu_torch.physics import fdm_cuda

    t_start = time.time()
    dev = torch.device(DEVICE)
    launches = dict.fromkeys(COUNTED, 0)
    cfg = presets.sb1_config(num_days_in_episode=1)
    env12 = building_env.BuildingEnv(cfg, device=dev)
    cheby12 = building_env.BuildingEnv(dataclasses.replace(cfg, fdm_solver="chebyshev"),
                                       device=dev)
    env126 = envs["126room"]
    for env in (env12, env126):
        geo = fdm_cuda.run_geometry(env.geom.shape, 1)
        if geo is None:
            fail(f"host path: no kernel geometry at B=1 for the {env.geom.shape} plan")
        print(f"  B=1 geometry at {env.geom.shape}: {geo.threads} threads x {geo.slots} runs, "
              f"staged={geo.staged}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        policy12 = host_policy(env12, 11, os.path.join(tmp, "p12"))
        policy126 = host_policy(env126, 12, os.path.join(tmp, "p126"))

    # (a) host12 and (e) chebyshev12 and (f) host126, against their plain runs.
    launches["fdm_jacobi"] += host_check("host12", env12, policy12, HOST_STEPS, "fdm_jacobi", tag)
    launches["fdm_cheby"] += host_check("chebyshev12", cheby12, policy12, CHEBY_STEPS,
                                        "fdm_cheby", tag)
    launches["fdm_jacobi"] += host_check("host126", env126, policy126, HOST126_STEPS,
                                         "fdm_jacobi", tag)

    # (b) The controller: the observation assembled from the proto against
    # the env's own, each step.
    building = host_adapter.SimulatedBuilding(env12, seed=1)
    controller = real_building.RealBuildingController(
        building, env12, lambda obs: policy12(obs[0])[None])
    diffs, observe = [], controller.observe

    def checked_observe():
        obs = observe()
        diffs.append(float(np.abs(obs - building._last_obs_vector).max()))
        return obs

    controller.observe = checked_observe
    fdm_cuda.reset_launch_counts()
    for _ in range(CONTROLLER_STEPS):
        controller.control_step()
    torch.cuda.synchronize()
    n = fdm_cuda.launch_counts["fdm_jacobi"]
    if n != CONTROLLER_STEPS or len(diffs) != CONTROLLER_STEPS or max(diffs) > 1e-5:
        fail(f"controller: K2 launches {n}, observation max |d| per step {diffs} (limit 1e-5)")
    launches["fdm_jacobi"] += n
    print(f"  controller ({CONTROLLER_STEPS} steps, 12 zones): K2 launches {n}; the observation "
          f"assembled from the proto within {max(diffs):.3e} of the env's (limit 1e-5)",
          flush=True)

    # (c) Rejection: the first REJECTIONS rewards are -inf.
    rejecting = host_adapter.RejectionSimulatedBuilding(
        host_adapter.SimulatedBuilding(env12, seed=2), num_rejections=REJECTIONS)
    host = host_environment.HostEnvironment(rejecting, env12)
    host.reset()
    fdm_cuda.reset_launch_counts()
    rewards = [host.step(np.zeros(env12.n_actions, np.float32)).reward
               for _ in range(REJECTIONS + 1)]
    n = fdm_cuda.launch_counts["fdm_jacobi"]
    if rewards[:REJECTIONS] != [-np.inf] * REJECTIONS or not np.isfinite(rewards[-1]) or (
            n != REJECTIONS + 1):
        fail(f"rejection: rewards {rewards}, K2 launches {n}")
    launches["fdm_jacobi"] += n
    print(f"  rejection ({REJECTIONS} refused): rewards {rewards}; K2 launches {n}", flush=True)

    # (d) The per-env step at B=1 against row ROW of step_batched at B=64.
    b = WIRING_BATCH
    states, _ = env12.reset(rng.split(rng.PRNGKey(21, device=dev), b))
    pick = lambda tree: {k: (pick(v) if isinstance(v, dict) else v[ROW:ROW + 1])
                         for k, v in tree.items()}
    one = convert.env_state_from_numpy(pick(convert.env_state_to_numpy(states)), dev)
    acts = torch.as_tensor(np.random.default_rng(22).uniform(-1, 1, (ROW_STEPS, b, env12.n_actions)),
                           dtype=torch.float32, device=dev)
    fdm_cuda.reset_launch_counts()
    for i in range(ROW_STEPS):
        states, out = env12.step_batched(states, acts[i], solver="pallas_env")
        one, one_out = env12.step(one, acts[i, ROW:ROW + 1])
        diff = _tree_diff(pick(convert.env_state_to_numpy(states)), convert.env_state_to_numpy(one))
        if diff or not torch.equal(one_out.observation, out.observation[ROW:ROW + 1]) or (
                not torch.equal(one_out.reward, out.reward[ROW:ROW + 1])):
            fail(f"step at B=1, step {i}: differs from row {ROW} of step_batched in {diff}")
    torch.cuda.synchronize()
    n = fdm_cuda.launch_counts["fdm_jacobi"]
    if dict(fdm_cuda.launch_counts) != {k: (2 * ROW_STEPS if k == "fdm_jacobi" else 0)
                                        for k in COUNTED}:
        fail(f"step at B=1: launch counts {fdm_cuda.launch_counts}")
    launches["fdm_jacobi"] += n
    print(f"  step at B=1 ({ROW_STEPS} steps from env {ROW} of B={b}): state and outputs bitwise "
          f"row {ROW} of step_batched through fdm_jacobi; K2 launches {n} ({ROW_STEPS} at B=1, "
          f"{ROW_STEPS} at B={b})", flush=True)
    print(f"  phase 7 in {time.time() - t_start:.1f} s", flush=True)
    return launches


# Phase 8: the offline-learning path. The recording runs at least
# OFFLINE_MIN_STEPS steps (and twice the framed features, so that the fit
# is overdetermined); its first OFFLINE_PLAIN_STEPS also under the plain
# versions. The bounds are tests/test_regression_pipeline.py's (:106, :155).
OFFLINE_MIN_STEPS = 144
OFFLINE_PLAIN_STEPS = 24
OFFLINE_SEED = 8
RIDGE_ALPHA = 1e-3
FIT_LIMIT_K = 0.5
SURROGATE_STEPS = 10
SURROGATE_LIMIT_K = 3.0
DASHBOARD_STEPS = 288
TRACE_STEPS = 4
ZONE_TEMP = "zone_air_temperature_sensor"
ZONE_TEMP_EDGES = (285.0, 290.0, 292.5, 295.0, 297.5, 300.0, 305.0)


def offline_record(env, steps, plain, directory, tag):
    """HostEnvironment over SimulatedBuilding(env, seed=0) recording `steps`
    seeded uniform actions into proto shards under `directory`, through the
    kernels or (with `plain`) their plain versions. Returns the episode
    directory, the launch counts and the ms of each step but the last (host
    clock); on the kernel run the last step is profiled."""
    import numpy as np
    from sbsim_tpu_torch.envs import host_adapter, host_environment
    from sbsim_tpu_torch.physics import fdm_cuda

    with plain_kernels() if plain else contextlib.nullcontext():
        host = host_environment.HostEnvironment(host_adapter.SimulatedBuilding(env, seed=0), env,
                                                metrics_path=directory, label="offline")
        host.reset()
        actions = np.random.default_rng(OFFLINE_SEED).uniform(-0.5, 0.5, (steps, env.n_actions))
        _sync()
        fdm_cuda.reset_launch_counts()
        ms = []
        for action in actions[:-1]:
            t0 = time.perf_counter()
            host.step(action)
            _sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        if plain:
            host.step(actions[-1])
        else:
            _profile_window(lambda: host.step(actions[-1]),
                            "offline12 profile of the last recorded step", tag)
        counts = dict(fdm_cuda.launch_counts)
    (episode,) = os.listdir(directory)
    return os.path.join(directory, episode), counts, ms


def frame_episode(reader, n=None):
    """The first `n` recorded steps (all when None) as the supervised tables
    of tests/test_regression_pipeline.py: inputs (time features,
    observations and the action taken at t) and outputs (the observations
    and energy rates at t + 1), and the messages they came from."""
    from sbsim_tpu_torch.utils import regression

    obs_responses = reader.read_observation_responses()[:n]
    action_responses = reader.read_action_responses()[:n]
    reward_infos = reader.read_reward_infos()[:n]
    obs = regression.observation_sequence(
        obs_responses, regression.feature_tuples(obs_responses[0])).set_index("timestamp")
    act = regression.action_sequence(
        action_responses, regression.action_tuples(action_responses[0])).set_index("timestamp")
    ri = regression.reward_info_sequence(
        reward_infos, regression.reward_info_tuples(reward_infos[0]))
    ri = ri.set_index((regression.REWARD_INFO, "timestamp", "end")).drop(
        columns=[(regression.REWARD_INFO, "timestamp", "start")])
    inputs = obs.join(act, how="inner")
    outputs = obs.drop(columns=[c for c in obs.columns if isinstance(c, str)]).join(
        ri, how="inner")
    return inputs, outputs, (obs_responses, action_responses, reward_infos)


def _same_frame(a, b) -> bool:
    import numpy as np

    return (a.columns == b.columns and list(a.index) == list(b.index)
            and a.objects == b.objects and a.values.shape == b.values.shape
            and np.array_equal(a.values, b.values, equal_nan=True))


def decode_png(data: bytes):
    """An 8-bit RGB PNG whose scanlines all use filter type 0 (what
    io/render.encode_png writes), decoded with the standard library; None
    if it is not one."""
    import struct
    import zlib

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] != (
                zlib.crc32(kind + body) & 0xFFFFFFFF):
            return None
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        return None
    width, height = header[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, 1 + 3 * width)
    return None if rows[:, 0].any() else rows[:, 1:].reshape(height, width, 3)


def offline_check_record(env, tmp, tag):
    """(a): record and frame. Returns the kernel run's episode directory,
    tables and messages, its K2 launches, its median ms per step and the
    building's default observation request."""
    import datetime

    import numpy as np
    from sbsim_tpu_torch.envs import host_adapter
    from sbsim_tpu_torch.io import records
    from sbsim_tpu_torch.utils import reducers, regression, telemetry

    cfg = env.config
    probe = host_adapter.SimulatedBuilding(env, seed=0)
    first = probe.request_observations(probe.default_observation_request())
    n_features = len(regression.feature_tuples(first)) + 4 + env.n_actions  # hod, dow cos/sin
    steps = max(OFFLINE_MIN_STEPS, 2 * n_features)
    folder, counts, ms = offline_record(env, steps, False, os.path.join(tmp, "kernel"), tag)
    plain_folder, plain_counts, plain_ms = offline_record(env, OFFLINE_PLAIN_STEPS, True,
                                                          os.path.join(tmp, "plain"), tag)
    if counts != {k: (steps if k == "fdm_jacobi" else 0) for k in COUNTED} or any(
            plain_counts.values()):
        fail(f"offline record: launch counts {counts}, plain run {plain_counts}")
    # The plain run's files hold the records of its steps; the kernel run's
    # files of the same names begin with the same bytes.
    names = sorted(os.listdir(plain_folder))
    for name in names:
        want = open(os.path.join(plain_folder, name), "rb").read()
        path = os.path.join(folder, name)
        got = open(path, "rb").read() if os.path.exists(path) else b""
        if not want or not got.startswith(want) or (name[-3] != "." and got != want):
            fail(f"offline record: {name} of the first {OFFLINE_PLAIN_STEPS} steps differs "
                 f"from the plain run's")
    reader, plain_reader = records.RecordReader(folder), records.RecordReader(plain_folder)
    tables = [frame_episode(reader, OFFLINE_PLAIN_STEPS)[:2], frame_episode(plain_reader)[:2]]
    if not all(_same_frame(a, b) for a, b in zip(*tables)):
        fail("offline record: the framed tables of the first steps differ from the plain run's")

    inputs, outputs, messages = frame_episode(reader)
    step = datetime.timedelta(seconds=cfg.time_step_sec)
    idx_in, idx_out = regression.match_sequence_indexes(inputs, outputs, step)
    if len(idx_in) != steps - 1 or any(b - a != step for a, b in zip(idx_in, idx_out)):
        fail(f"offline record: {len(idx_in)} (input, output) pairs of {steps} steps, or not "
             "one step apart")
    frame = telemetry.observation_responses_to_frame(messages[0])
    stats = reducers.StatsReducer().reduce(frame).reduced_sequence
    groups = {}
    for col in frame.columns:
        groups[col[1]] = groups.get(col[1], 0) + 1
    for measurement, stat in stats.columns:
        finite = np.isfinite(stats[(measurement, stat)])
        if not (finite.all() if stat != "std" or groups[measurement] > 1 else (~finite).all()):
            fail(f"offline record: StatsReducer {measurement} {stat} not finite where its "
                 "inputs are")
    hist = reducers.HistogramReducer({ZONE_TEMP: ZONE_TEMP_EDGES}).reduce(frame)
    counts_cols = [(ZONE_TEMP, "h_%.2f" % e) for e in ZONE_TEMP_EDGES]
    bins = hist.reduced_sequence[counts_cols].to_numpy()
    expanded = hist.expand()
    if not (np.isfinite(hist.reduced_sequence.values).all()
            and (bins.sum(axis=1) == groups[ZONE_TEMP]).all()
            and len(expanded.columns) == len(frame.columns)):
        fail(f"offline record: HistogramReducer counts {bins.sum(axis=1)} for "
             f"{groups[ZONE_TEMP]} zone sensors, or its expansion has "
             f"{len(expanded.columns)} columns for {len(frame.columns)}")
    print(f"  (a) record: {steps} HostEnvironment steps (F = {n_features} framed features) "
          f"through K2, launches {counts['fdm_jacobi']} (plain run 0); the first "
          f"{OFFLINE_PLAIN_STEPS} steps' {len(names)} record files and tables bitwise the "
          f"plain run's; inputs {len(inputs)} x {len(inputs.columns)}, outputs "
          f"{len(outputs)} x {len(outputs.columns)}, {len(idx_in)} pairs one step apart; "
          f"StatsReducer {len(stats.columns)} and HistogramReducer {len(counts_cols)} zone-"
          f"temperature bins finite; {statistics.median(ms[2:]):.3f} ms per simulated step "
          f"(plain run {statistics.median(plain_ms[2:]):.3f} ms) {tag}", flush=True)
    return dict(folder=folder, tables=(inputs, outputs, idx_in, idx_out), messages=messages,
                launches=counts["fdm_jacobi"], ms=statistics.median(ms[2:]),
                request=probe.default_observation_request())


class _ConstantOccupancy:
    def average_zone_occupancy(self, zone_id, start_time, end_time):
        return 1.0


def offline_check_fit(env, recorded, tag):
    """(b): a ridge fit on the card drives a RegressionBuilding over the
    recorded actions; the run-command predictor's inputs."""
    import numpy as np
    import torch
    from sbsim_tpu_torch.io import records
    from sbsim_tpu_torch.utils import conversions, regression
    from sbsim_tpu_torch.utils import run_command_predictor as rcp

    dev = torch.device(DEVICE)
    inputs, outputs, idx_in, idx_out = recorded["tables"]
    feature_cols, target_cols = list(inputs.columns), list(outputs.columns)
    x = torch.as_tensor(inputs.loc[idx_in, feature_cols], device=dev)
    y = torch.as_tensor(outputs.loc[idx_out, target_cols], device=dev)
    # Ridge regression with an intercept (sklearn's Ridge(alpha) on centred
    # columns), in float64.
    x_mean, y_mean = x.mean(0), y.mean(0)
    xc = x - x_mean
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=dev)
    weights = torch.linalg.solve(xc.T @ xc + RIDGE_ALPHA * eye, xc.T @ (y - y_mean))
    bias = y_mean - x_mean @ weights
    temp_cols = [i for i, c in enumerate(target_cols) if c[1] == ZONE_TEMP]
    fit_err = float((x @ weights + bias - y)[:, temp_cols].abs().max())
    if not temp_cols or not fit_err < FIT_LIMIT_K:
        fail(f"offline fit: one-step zone-temperature error {fit_err} K (limit {FIT_LIMIT_K})")

    def predict(row):
        vec = torch.as_tensor([float(row.get(c, 0.0)) for c in feature_cols],
                              dtype=torch.float64, device=dev)
        return dict(zip(target_cols, (vec @ weights + bias).cpu().numpy()))

    obs_responses, action_responses, _ = recorded["messages"]
    reader = records.RecordReader(recorded["folder"])
    spec = regression.RegressionBuildingSpec(
        devices=reader.read_device_infos(), zones=reader.read_zone_infos(),
        time_step_sec=env.config.time_step_sec,
        start_timestamp=conversions.proto_to_pandas_timestamp(obs_responses[0].timestamp),
        occupancy=_ConstantOccupancy(), schedule_window=lambda ts: (294.0, 297.0),
        is_comfort_mode=lambda ts: True, sensors_in_fahrenheit=False)
    surrogate = regression.RegressionBuilding(spec, predict, obs_responses[0])
    request = recorded["request"]
    zone_keys = [c for c in target_cols if c[1] == ZONE_TEMP]
    errs, ms = [], []
    for i in range(1, SURROGATE_STEPS + 1):
        # The calls HostEnvironment.step makes on its building.
        t0 = time.perf_counter()
        surrogate.request_action(action_responses[i].request)
        surrogate.wait_time()
        predicted = regression.observation_mapping(surrogate.request_observations(request))
        info = surrogate.reward_info
        ms.append((time.perf_counter() - t0) * 1e3)
        actual = regression.observation_mapping(obs_responses[i])
        errs.append(max(abs(predicted[k] - actual[k]) for k in zone_keys))
    if not max(errs) < SURROGATE_LIMIT_K:
        fail(f"offline surrogate: zone temperatures {errs} K from the recorded run (limit "
             f"{SURROGATE_LIMIT_K})")
    if not (len(info.zone_reward_infos) == env.n_zones and info.air_handler_reward_infos
            and info.boiler_reward_infos):
        fail(f"offline surrogate: reward_info with {len(info.zone_reward_infos)} zones, "
             f"{len(info.air_handler_reward_infos)} air handlers, "
             f"{len(info.boiler_reward_infos)} boilers")
    print(f"  (b) fit: ridge (alpha {RIDGE_ALPHA}) on the card, {x.shape[0]} x {x.shape[1]} "
          f"-> {y.shape[1]}, one-step zone-temperature error {fit_err:.4f} K (limit "
          f"{FIT_LIMIT_K}); RegressionBuilding over {SURROGATE_STEPS} recorded actions within "
          f"{max(errs):.4f} K of the recorded run (limit {SURROGATE_LIMIT_K}); reward_info "
          f"{len(info.zone_reward_infos)} zones, {len(info.air_handler_reward_infos)} air "
          f"handler, {len(info.boiler_reward_infos)} boiler; {statistics.median(ms):.3f} ms "
          f"per surrogate step against {recorded['ms']:.3f} ms per simulated step {tag}",
          flush=True)

    timeseries = rcp.get_action_timeseries(action_responses)
    order, matrix = rcp.setpoint_matrix(timeseries)
    features = np.stack([rcp.action_request_to_features(r.request, order)
                         for r in action_responses])
    if not np.array_equal(matrix, features):
        fail("offline run commands: the pivoted setpoints differ from the requests' features")
    try:
        import sklearn  # noqa: F401
    except ImportError:
        print(f"  (b) run commands: {len(timeseries)} setpoints of {len(order)} kinds pivoted "
              f"to {matrix.shape}, equal to the requests' features; scikit-learn is not "
              f"importable here, so the predictor was not fitted", flush=True)
        return
    boiler = order.index(("boiler", "supply_water_setpoint"))
    on = features[:, boiler] > np.median(features[:, boiler])
    predictor = rcp.RandomForestRunCommandPredictor("boiler")
    score = predictor.fit(timeseries, on)
    print(f"  (b) run commands: {matrix.shape} setpoints, equal to the requests' features; "
          f"scikit-learn fitted the predictor, train accuracy {score:.3f}", flush=True)


def _dashboard(steps, out, draw, fields, times, plain=False, profile_step=None, tag="",
               eager=False):
    """episode_dashboard.main for `steps` steps, through K2 or (with
    `plain`) its plain version, the per-env step captured (with `eager` op
    by op); the run and its launch counts. Each step's field goes into
    `fields` (the first OFFLINE_PLAIN_STEPS) and its host time into
    `times`; step `profile_step` (0-based), if given, runs in a profiler
    window."""
    from sbsim_tpu_torch import graphs
    from sbsim_tpu_torch.examples import episode_dashboard
    from sbsim_tpu_torch.physics import fdm_cuda

    window = []

    def hook(t, state):
        if t < OFFLINE_PLAIN_STEPS:
            fields.append(state.temp[0].cpu().numpy())
        times.append(time.perf_counter())
        if profile_step is not None and t == profile_step - 1:
            window.append(_open_window())
        elif window:
            _close_window(window.pop(), f"dashboard12 profile of step {t + 1}", tag)

    argv = ["--steps", str(steps), "--render-every", str(72 if draw else 0), "--out", out]
    with plain_kernels() if plain else contextlib.nullcontext(), (
            graphs.disabled() if eager else contextlib.nullcontext()):
        _sync()
        fdm_cuda.reset_launch_counts()
        run = episode_dashboard.main(argv, on_step=hook)
        _sync()
        counts = dict(fdm_cuda.launch_counts)
    return run, counts


def offline_check_dashboard(recorded, tmp, tag):
    """(c): the dashboard example for a whole day through K2; its first
    steps bitwise the plain run's; the PNG of a recorded observation."""
    import base64

    import numpy as np
    from sbsim_tpu_torch.io import records, render
    from sbsim_tpu_torch.utils import conversions

    try:
        import matplotlib  # noqa: F401
        draw = True
    except ImportError:
        draw = False
    fields, times, plain_fields = [], [], []
    run, counts = _dashboard(DASHBOARD_STEPS, os.path.join(tmp, "dash"), draw, fields, times,
                             profile_step=DASHBOARD_STEPS - 1, tag=tag)
    plain, plain_counts = _dashboard(OFFLINE_PLAIN_STEPS, os.path.join(tmp, "dash_plain"), False,
                                     plain_fields, [], plain=True)
    if counts != {k: (DASHBOARD_STEPS if k == "fdm_jacobi" else 0) for k in COUNTED} or any(
            plain_counts.values()) or run.steps != DASHBOARD_STEPS:
        fail(f"dashboard: {run.steps} steps, launch counts {counts}, plain run {plain_counts}")
    env, dash, want = run.env, run.dashboard, plain.dashboard
    n = OFFLINE_PLAIN_STEPS
    wall = np.asarray(env.geom.zone_ids) >= env.geom.n_zones
    renderer = render.BuildingRenderer(wall)
    frames = [renderer.render_array(f) for f in fields]
    same = (np.array_equal(np.stack(dash.zone_temps[:n]), np.stack(want.zone_temps))
            and all(dash.energy_rates[k][:n] == want.energy_rates[k] for k in want.energy_rates)
            and dash.timestamps[:n] == want.timestamps
            and all(np.array_equal(a, renderer.render_array(b))
                    for a, b in zip(frames, plain_fields, strict=True)))
    if not same or not np.isfinite(np.stack(dash.zone_temps)).all():
        fail("dashboard: the first steps' zone temperatures, energy rates or frames differ from "
             "the plain run's, or a zone temperature is not finite")
    devices = records.RecordReader(recorded["folder"]).read_device_infos()
    last = recorded["messages"][0][-1]
    generator = render.BuildingImageGenerator(
        env.geom.zone_ids, [conversions.floor_plan_based_zone_identifier_to_id(z)
                            for z in env.geom.zone_names], wall_mask=wall,
        device_to_zone_id={d.device_id: d.zone_id for d in devices if d.zone_id})
    array = generator.temperature_array(last)
    png = decode_png(base64.b64decode(generator.generate_building_image(last)))
    if png is None or not np.array_equal(png, generator._renderer.render_array(array)) or not (
            array[np.asarray(env.geom.zone_ids) < env.geom.n_zones] != 285.0).all():
        fail("dashboard: the base64 PNG does not decode to the rendered frame of the last "
             "recorded observation, or a zone is left unpainted")
    ms = np.diff(times)[2:-1] * 1e3  # the last step ran in the profiler
    print(f"  (c) dashboard: {DASHBOARD_STEPS} steps of episode_dashboard.main, K2 launches "
          f"{counts['fdm_jacobi']} (plain run 0); the first {n} steps' zone temperatures, "
          f"energy rates and render_array frames bitwise the plain run's; the PNG of the last "
          f"recorded observation ({png.shape[1]} x {png.shape[0]}) decodes to its frame; "
          f"figures {'drawn every 72 steps (matplotlib)' if draw else 'not drawn (matplotlib is not importable)'}; "
          f"{statistics.median(ms):.3f} ms per step -> {1e3 / statistics.median(ms):.1f} "
          f"env-steps/s {tag}", flush=True)
    return counts["fdm_jacobi"]


def offline_check_trace(tmp, tag):
    """(d): TRACE_STEPS dashboard steps under utils.profiling.device_trace;
    the trace must name K2 (a window the profiler left without device events
    is traced again, up to PROFILE_TRIES times). Returns the launches."""
    from sbsim_tpu_torch.utils import profiling

    launches = 0
    for attempt in range(1, PROFILE_TRIES + 1):
        trace_dir = os.path.join(tmp, f"trace{attempt}")
        with profiling.device_trace(trace_dir):
            _, counts = _dashboard(TRACE_STEPS, os.path.join(tmp, "dash_trace"), False, [], [])
        launches += counts["fdm_jacobi"]
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
                  if f.endswith(".pt.trace.json")]
        if len(traces) != 1:
            fail(f"trace: {len(traces)} trace files in {trace_dir}")
        if "fdm_jacobi" in open(traces[0]).read():
            break
        profile_windows["empty"] += 1
    else:
        fail(f"trace: no window of {PROFILE_TRIES} named fdm_jacobi")
    print(f"  (d) trace: device_trace of {TRACE_STEPS} dashboard steps wrote "
          f"{os.path.basename(traces[0])} ({os.path.getsize(traces[0])} bytes) naming "
          f"fdm_jacobi (window {attempt}); K2 launches {launches} {tag}", flush=True)
    return launches


def offline_phase(tag) -> dict:
    """Phase 8: the offline-learning path on the card; returns the launches
    of its kernel runs."""
    import tempfile

    import torch
    from sbsim_tpu_torch.envs import building_env, presets
    from sbsim_tpu_torch.utils import profiling

    t_start = time.time()
    launches = dict.fromkeys(COUNTED, 0)
    env = building_env.BuildingEnv(presets.sb1_config(num_days_in_episode=1),
                                   device=torch.device(DEVICE))
    timer = profiling.PhaseTimer()
    with tempfile.TemporaryDirectory() as tmp:
        with timer.phase("(a) record and frame"):
            recorded = offline_check_record(env, tmp, tag)
        launches["fdm_jacobi"] += recorded["launches"]
        with timer.phase("(b) fit and drive"):
            offline_check_fit(env, recorded, tag)
        with timer.phase("(c) dashboard"):
            launches["fdm_jacobi"] += offline_check_dashboard(recorded, tmp, tag)
        launches["fdm_jacobi"] += offline_check_trace(tmp, tag)
    print("  phase timer (host wall time of (a)-(c)):", flush=True)
    for line in timer.report().splitlines():
        print("    " + line, flush=True)
    print(f"  phase 8 in {time.time() - t_start:.1f} s", flush=True)
    return launches


# Phase 9: the validation path. The port's device path against its exact
# host simulator (the numpy FDM oracles, the reference's random streams).
PARITY_STEPS = 288  # a simulated day
GATE_STEP = 24  # tests/test_device_vs_host.py:44-96's gates
STACK_BATCH = 4
KS_LIMIT, DMEAN_LIMIT = 0.25, 0.5  # tests/test_convection.py:178-277
# K1's worst zone KS and zone-mean difference (K) against the exact shuffle
# on conv_rounds_sweep.SWAP_KEY's keys, as the JAX package's own interleaved Chebyshev
# kernel (_fdm_cheby_kernel_interleaved in interpret mode, swap rounds in
# the kernel) gives them on the CPU (tests/test_torch_shuffle.py). The
# Chebyshev solve converges past the loosely stopped Jacobi solve of the
# exact host, so these sit outside KS_LIMIT / DMEAN_LIMIT; K1 on the card
# is held to them within WITNESS_KS_TOL (8 of the worst zone's 392 samples) and
# WITNESS_DMEAN_TOL.
K1_WITNESS = (0.9183673469387755, 0.502685546875)
WITNESS_KS_TOL, WITNESS_DMEAN_TOL = 0.02, 0.01
GIN_BATCH = 64
GIN_STEPS = 3
SETPOINTS = {"supply_water_setpoint": 340.0, "supply_air_heating_temperature_setpoint": 285.0}
GIN_TEXT = """
# Calibration constants in the layout of sim_config.gin.
time_step_sec = 300
convergence_threshold = 0.1
iteration_limit = 100
num_days_in_episode = 1
control_volume_cm = 20
floor_height_cm = 300.0
air_heat = 286.0
air_handler_heating_setpoint = %air_heat
reheat_water_setpoint = 350.0
heating_setpoint_day = 294
cooling_setpoint_day = 297
time_zone = 'US/Eastern'
start_timestamp = '2023-07-06 12:00:00+00:00'
StochasticConvectionSimulator.p = 1.0
StochasticConvectionSimulator.distance = 5
StochasticConvectionSimulator.seed = 7
SimulatorBuilding.simulator = @TFSimulator()
histogram_parameters_tuples = (
    ('zone_air_temperature_sensor', (285.0, 290.0, 292.5, 295.0, 297.5, 300.0, 305.0)),
)
zone_air_temperature_normalizer/set_observation_normalization_constants.field_id = 'zone_air_temperature_sensor'
zone_air_temperature_normalizer/set_observation_normalization_constants.sample_mean = 295.5
zone_air_temperature_normalizer/set_observation_normalization_constants.sample_variance = 9.25
supply_air_temperature_setpoint_normalizer/set_observation_normalization_constants.field_id = 'supply_air_temperature_setpoint'
supply_air_temperature_setpoint_normalizer/set_observation_normalization_constants.sample_mean = 289.329414
supply_air_temperature_setpoint_normalizer/set_observation_normalization_constants.sample_variance = 3.186769
observation_normalizer_map = {
    'zone_air_temperature_sensor': @zone_air_temperature_normalizer/set_observation_normalization_constants(),
    'supply_air_heating_temperature_setpoint': @supply_air_temperature_setpoint_normalizer/set_observation_normalization_constants(),
}
supply_water_setpoint/set_action_normalization_constants.min_native_value = 310.0
supply_water_setpoint/set_action_normalization_constants.max_native_value = 350.0
supply_air_heating_temperature_setpoint/set_action_normalization_constants.min_native_value = 285.0
supply_air_heating_temperature_setpoint/set_action_normalization_constants.max_native_value = 300.0
action_normalizer_map = {
    'supply_water_setpoint': @supply_water_setpoint/set_action_normalization_constants(),
    'supply_air_heating_temperature_setpoint': @supply_air_heating_temperature_setpoint/set_action_normalization_constants(),
}
"""


def parity_config(stack=False):
    """sb1_config(num_days_in_episode=1, convection_p=0) with step-function
    occupancy (the deterministic inputs of tests/test_device_vs_host.py)."""
    from sbsim_tpu_torch.envs import presets

    cfg = presets.sb1_config(num_days_in_episode=1, convection_p=0.0)
    cfg = dataclasses.replace(cfg, occupancy=dataclasses.replace(cfg.occupancy,
                                                                 kind="step_function"))
    if stack:
        cfg = dataclasses.replace(cfg, pallas_block_mode="stack")
    return cfg


def energy_rates(env, state, row=0):
    """(electricity, gas) rates of the reward at the state's step, as
    tests/test_device_vs_host.py:75-96 computes them."""
    import torch
    from sbsim_tpu_torch.hvac import devices as hvac_ops

    t = int(state.step_idx[row])
    ambient = torch.tensor(env.tables.ambient_temp[t], dtype=torch.float32, device=env.device)
    blower = float(hvac_ops.ahu_blower_power(state.hvac, env.hvac_params)[row])
    ac = float(hvac_ops.ahu_thermal_energy_rate(state.hvac, state.temp.mean(dim=(1, 2)), ambient,
                                                env.hvac_params)[row])
    pump = float(hvac_ops.boiler_pump_power(state.hvac, env.hvac_params)[row])
    gas = float(hvac_ops.boiler_thermal_energy_rate(state.hvac, ambient, env.hvac_params)[row])
    return blower + abs(ac) + pump, gas


def parity_run(label, env, steps, kname, tag, batch=1, gates=False, allow_crossings=True):
    """`steps` device steps beside the port's ExactHostSimulator: the
    per-env step at B=1, or step_batched through the config's kernel at
    `batch` identical envs (rows bitwise equal to each other). Every step
    held by exact_host.ParityTracker (max |dT| < 5e-2 K, thermostat modes
    equal, apart from threshold crossings that recover by the last step;
    without `allow_crossings`, none at all); with `gates`, the boiler,
    return-water and energy-rate gates at step GATE_STEP. Returns the
    launches of `kname` and the tracker's report."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.envs import exact_host
    from sbsim_tpu_torch.physics import fdm_cuda

    host = exact_host.ExactHostSimulator(env)
    keys = rng.PRNGKey(0, device=env.device)[None].expand(batch, -1).contiguous()
    state, _ = env.reset(keys)
    action = torch.as_tensor(env.default_action(SETPOINTS), device=env.device)[None]
    action = action.expand(batch, -1).contiguous()
    tracker = exact_host.ParityTracker()
    event = lambda: torch.cuda.Event(enable_timing=True)
    device_ms, host_ms = [], []
    _sync()
    fdm_cuda.reset_launch_counts()
    for i in range(steps):
        s, e = event(), event()
        s.record()
        if batch == 1:
            state, _ = env.captured_step(state, action)
        else:
            state, _ = env.step_batched(state, action, solver="pallas_env")
        e.record()
        t0 = time.perf_counter()
        host_out = host.step(SETPOINTS)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        temp = state.temp.cpu().numpy()
        if batch > 1 and not all(np.array_equal(temp[0], temp[r]) for r in range(1, batch)):
            fail(f"{label}: step {i}: the {batch} identical envs differ")
        try:
            tracker.check(i, temp[0], state.hvac.thermostat_mode[0].tolist(),
                          state.hvac.zone_air_temp[0].tolist(), host)
        except exact_host.ParityError as err:
            fail(f"{label}: {err}")
        device_ms.append(s.elapsed_time(e))
        if gates and i == GATE_STEP - 1:
            elec, gas = energy_rates(env, state)
            checks = {
                "boiler temperature": (float(state.hvac.boiler_current_temp[0]),
                                       host.boiler_current_temp, 1e-4, 0.0),
                "return water": (float(state.hvac.boiler_return_water_temp[0]),
                                 host.boiler_return_water, 1e-2, 0.0),
                "electricity rate": (elec, host_out["electricity_rate"], 1.0, 1e-4),
                "gas rate": (gas, host_out["gas_rate"], 5.0, 1e-3),
            }
            for what, (got, want, atol, rtol) in checks.items():
                if not abs(got - want) <= atol + rtol * abs(want):
                    fail(f"{label}: step {GATE_STEP}: {what} {got} against the host's {want} "
                         f"(atol {atol}, rtol {rtol})")
            print(f"  {label} at step {GATE_STEP}: " + ", ".join(
                f"{what} {got:.6f} (host {want:.6f})" for what, (got, want, _, _) in checks.items()),
                flush=True)
    _sync()
    counts = dict(fdm_cuda.launch_counts)
    if counts != {k: (steps if k == kname else 0) for k in COUNTED}:
        fail(f"{label}: launch counts {counts}, want {steps} of {kname}")
    try:
        r = tracker.finish(allow_crossings)
    except exact_host.ParityError as err:
        fail(f"{label}: {err}")
    back = {first: last - first + 1 for first, last in r.windows}
    crossings = "; ".join(
        f"zones {list(z)} at step {st} (margin {m:.3e} K), back within the budget with "
        f"modes equal after {back[st]} steps" for st, z, m in r.crossings)
    print(f"  {label} ({env.geom.n_zones} zones, {env.geom.shape[0]} x {env.geom.shape[1]}, "
          f"B={batch}; {steps} steps through {kname}, launches {counts[kname]}): largest drift "
          f"{r.max_drift:.6e} K at step {r.max_drift_step} (budget {tracker.budget}), last "
          f"step's {r.last_drift:.6e} K, modes equal outside recovery windows; threshold "
          f"crossings: {crossings or 'none'}", flush=True)
    print(f"  {label} rates: device step median {statistics.median(device_ms):.3f} ms (CUDA "
          f"events), exact-host step median {statistics.median(host_ms):.3f} ms (host clock) "
          f"{tag}", flush=True)
    return counts[kname], r


def gin_check(tmp, tag) -> int:
    """(e): an env from a gin calibration through K1 and through the plain
    versions, bitwise; the legacy wiring's host solver. Returns K1's
    launches."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import convert, rng
    from sbsim_tpu_torch.envs import building_env, gin_compat
    from sbsim_tpu_torch.physics import fdm_cuda

    path = os.path.join(tmp, "sim_config.gin")
    with open(path, "w") as f:
        f.write(GIN_TEXT)
    cfg = gin_compat.env_config_from_gin(path)
    if (cfg.host_solver, cfg.schedule.time_zone, cfg.hvac.ahu_heating_setpoint) != (
            "jacobi", "US/Eastern", 286.0):
        fail(f"gin12: config {cfg.host_solver}, {cfg.schedule.time_zone}, "
             f"{cfg.hvac.ahu_heating_setpoint}")
    env = building_env.BuildingEnv(cfg, device=torch.device(DEVICE))
    keys = rng.split(rng.PRNGKey(13, device=env.device), GIN_BATCH)
    acts = torch.as_tensor(np.random.default_rng(14).uniform(-1, 1, (GIN_STEPS, GIN_BATCH,
                                                                      env.n_actions)),
                           dtype=torch.float32, device=env.device)

    def run(plain):
        states, obs = env.reset(keys)
        outs = []
        with plain_kernels() if plain else contextlib.nullcontext():
            for i in range(GIN_STEPS):
                states, out = env.step_batched(states, acts[i], solver="pallas_cheby")
                outs.append((out.observation.cpu().numpy(), out.reward.cpu().numpy()))
        return convert.env_state_to_numpy(states), outs

    _sync()
    fdm_cuda.reset_launch_counts()
    got, got_out = run(False)
    _sync()
    counts = dict(fdm_cuda.launch_counts)
    want, want_out = run(True)
    _sync()
    if counts != {k: (GIN_STEPS if k == "fdm_cheby" else 0) for k in COUNTED} or any(
            fdm_cuda.launch_counts[k] != counts[k] for k in KERNELS):
        fail(f"gin12: launch counts {counts}, after the plain run {fdm_cuda.launch_counts}")
    _check_equal_trees("gin12", got, want)
    for i, ((o1, r1), (o2, r2)) in enumerate(zip(got_out, want_out)):
        if not (np.array_equal(o1, o2) and np.array_equal(r1, r2)):
            fail(f"gin12: step {i}: observations or rewards differ from the plain run")
    legacy = os.path.join(tmp, "sim_config_legacy.gin")
    with open(legacy, "w") as f:
        f.write(GIN_TEXT.replace("@TFSimulator()", "@SimulatorFlexibleGeometries()"))
    solver = gin_compat.env_config_from_gin(legacy).host_solver
    if solver != "gauss_seidel":
        fail(f"gin12: SimulatorFlexibleGeometries gives host_solver {solver!r}")
    print(f"  gin12 (env_config_from_gin, {env.n_zones} zones, B={GIN_BATCH}, "
          f"{GIN_STEPS} steps through fdm_cheby, launches {counts['fdm_cheby']}): states, "
          f"observations and rewards bitwise equal to the plain versions; host_solver "
          f"'jacobi' for TFSimulator, 'gauss_seidel' for SimulatorFlexibleGeometries", flush=True)
    return counts["fdm_cheby"]


def native_check(tmp) -> None:
    """(f): the g++ builds of the native libraries, and phase 7's host12
    shards read through the native scanner against a Python framing."""
    from sbsim_tpu_torch import native
    from sbsim_tpu_torch.io import records

    for name in ("floorplan_ops", "record_io"):
        native.load(name)
        print(f"  native {name}: {os.path.relpath(native.library_path(name), REPO)}, g++ "
              f"build {native.build_seconds[name]:.2f} s in this process (0.00: built "
              f"before it)", flush=True)
    files = HOST_SHARDS.get("host12")
    if not files:
        fail("native: phase 7's host12 record files are missing")
    n_messages = 0
    for name, data in files.items():
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            f.write(data)
        framed, at = [], 0
        while at < len(data):
            size = int.from_bytes(data[at:at + 4], "little")
            framed.append(data[at + 4:at + 4 + size])
            at += 4 + size
        if at != len(data) or native.read_record_payloads(path) != framed:
            fail(f"native: {name}: the native scanner's payloads differ from the Python "
                 f"framing ({len(framed)} records)")
        prefix = next((p for p in records._PREFIX_TO_MESSAGE if name.startswith(p + "_")),
                      None)
        if prefix is not None:
            kind = records._PREFIX_TO_MESSAGE[prefix]
            if list(records.read_records(path, kind)) != [kind.FromString(x) for x in framed]:
                fail(f"native: {name}: messages differ from the Python framing's")
        n_messages += len(framed)
    print(f"  native record scanner: {len(files)} host12 record files, {n_messages} records "
          f"equal to a Python framing, payload for payload and message for message", flush=True)


def validation_phase(tag) -> dict:
    """Phase 9: the validation path on the card; returns the launches of
    its kernel runs."""
    import tempfile

    import torch
    from sbsim_tpu_torch.envs import building_env

    t_start = time.time()
    dev = torch.device(DEVICE)
    launches = dict.fromkeys(COUNTED, 0)
    # (a) parity12: the per-env step through K2 over a day.
    env12 = building_env.BuildingEnv(parity_config(), device=dev)
    n, report12 = parity_run("parity12", env12, PARITY_STEPS, "fdm_jacobi", tag, gates=True)
    launches["fdm_jacobi"] += n
    # (b) parity12 stack: step_batched through K3 at B=4 identical envs; the
    # same day, so the same crossings as (a)'s.
    stack12 = building_env.BuildingEnv(parity_config(stack=True), device=dev)
    n, report = parity_run("parity12 stack", stack12, PARITY_STEPS, "fdm_jacobi_block", tag,
                           batch=STACK_BATCH)
    launches["fdm_jacobi_block"] += n
    if [c[:2] for c in report.crossings] != [c[:2] for c in report12.crossings]:
        fail(f"parity12 stack: threshold crossings {report.crossings}, parity12's "
             f"{report12.crossings}")
    # (e) gin12 through K1, (f) native; (c) parity126 and (d) shuffle12 run
    # through the scripts in phase 11.
    with tempfile.TemporaryDirectory() as tmp:
        launches["fdm_cheby"] += gin_check(tmp, tag)
        native_check(tmp)
    print(f"  phase 9 in {time.time() - t_start:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the distributed path
# ---------------------------------------------------------------------------

DIST_ENVS = 64  # examples/train_sac.py's recipe
DIST_SEED_STEPS = 8
DIST_TRAIN_STEPS = 8
DIST_RANKS = 2  # (a); NCCL cannot put two ranks on one card, gloo can
NCCL_STEPS = 4  # (c)
DIST_TIMEOUT = 300.0  # seconds: each job's deadline, and its collectives'
# tests/test_distributed.py's tolerances for N ranks against one program.
DIST_TOL = {"reward": 1e-5, "temp": 1e-4, "replay_reward": 1e-5, "param": 1e-5,
            "log_alpha": 1e-6}


def _train_recipe(env):
    from sbsim_tpu_torch.agents import train

    return train.SACTrainer(env, train.recipe_for(
        env, n_envs=DIST_ENVS, batch_size=256, replay_capacity=50_000,
        updates_per_env_step=1, seed_steps=0))


def _events():
    import torch

    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _timed_all_reduce(spans):
    """Wraps runtime.all_reduce_mean so that each call records its CUDA
    events in `spans` while `on[0]` holds (returns `on`; a call inside a
    captured program, whose events would be captured, must not record)."""
    from sbsim_tpu_torch.distributed import runtime

    inner, on = runtime.all_reduce_mean, [True]

    def call(tensors, group):
        if not on[0]:
            return inner(tensors, group)
        s, e = _events()
        s.record()
        out = inner(tensors, group)
        e.record()
        spans.append((s, e, sum(t.numel() for t in tensors)))
        return out

    runtime.all_reduce_mean = call
    return on


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _dump(path, tree) -> None:
    import numpy as np

    np.savez(path, **_flat_tree(tree))


def _undump(path) -> dict:
    import numpy as np

    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _rank_train(rank, mesh, device, out) -> dict:
    """(a) and (d) on one rank: schedule-table seeding through
    make_distributed_collect_step, make_shardmapped_train_step, the
    sharded checkpoint. On an NCCL group the steps are captured programs;
    the train steps then run again op by op (`eager`) from the seeded
    state, whose state and metrics they must equal bitwise, and the
    all-reduces are timed on that run."""
    import torch
    from sbsim_tpu_torch import convert, graphs, rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.distributed import mesh as mesh_lib
    from sbsim_tpu_torch.distributed import runtime
    from sbsim_tpu_torch.io.checkpoint import TrainCheckpointer
    from sbsim_tpu_torch.physics import fdm_cuda

    env = make_env("12zone", device)
    trainer = _train_recipe(env)
    state = mesh_lib.shard_train_state(trainer.init(rng.PRNGKey(0, device=device)), mesh)
    seed = mesh_lib.make_distributed_collect_step(
        trainer, mesh, schedule_policy.build_schedule_actions(env))
    step = mesh_lib.make_shardmapped_train_step(trainer, mesh, state)
    captured = runtime.captures(mesh.group)
    spans, metrics = [], []
    timing = _timed_all_reduce(spans)
    timing[0] = not captured
    torch.cuda.synchronize()
    fdm_cuda.reset_launch_counts()
    for _ in range(DIST_SEED_STEPS):
        state, _ = seed(state)
    seeded = convert.train_state_to_numpy(mesh_lib.gather_train_state(state, mesh), trainer)
    start = graphs.tree_map(torch.clone, state)
    spans.clear()

    def run(fn, state):
        events = []
        for _ in range(DIST_TRAIN_STEPS):
            s, e = _events()
            s.record()
            state, m = fn(state)
            e.record()
            events.append((s, e))
            metrics.append(m)
        return state, events

    state, steps = run(step, state)
    torch.cuda.synchronize()
    launches = dict(fdm_cuda.launch_counts)
    trained = convert.train_state_to_numpy(mesh_lib.gather_train_state(state, mesh), trainer)
    eager = {}
    if captured:
        graph_metrics = metrics[:]
        metrics.clear()
        timing[0] = True
        eager_state, eager_steps = run(step.eager, start)
        torch.cuda.synchronize()
        diff = _tree_diff(convert.train_state_to_numpy(eager_state, trainer),
                          convert.train_state_to_numpy(state, trainer))
        diff += [(f"metric {k} of step {i}", float("nan"))
                 for i, (a, b) in enumerate(zip(graph_metrics, metrics)) for k in a
                 if not torch.equal(a[k], b[k])]
        eager = {"diff": diff, "step_ms": [s.elapsed_time(e) for s, e in eager_steps]}
        metrics = graph_metrics
    if rank == 0:
        _dump(f"{out}/seeded.npz", seeded)
        _dump(f"{out}/trained.npz", trained)
    TrainCheckpointer(f"{out}/ckpt", trainer, mesh=mesh).save(DIST_TRAIN_STEPS, state)
    per_update = [s.elapsed_time(e) for s, e, _ in spans]
    return {"launches": launches, "rows": int(state.last_obs.shape[0]),
            "step_ms": [s.elapsed_time(e) for s, e in steps], "eager": eager,
            "all_reduce_ms": per_update, "all_reduce_floats": [n for *_, n in spans],
            "metrics": [{k: float(v) for k, v in m.items()} for m in metrics]}


def _rank_nccl(rank, mesh, device, out) -> dict:
    """(c): make_distributed_train_step on a one-rank NCCL group against
    trainer.train_step from the same init, NCCL_STEPS steps each."""
    import torch
    from sbsim_tpu_torch import convert, rng
    from sbsim_tpu_torch.distributed import mesh as mesh_lib
    from sbsim_tpu_torch.physics import fdm_cuda

    env = make_env("12zone", device)
    trainer = _train_recipe(env)
    ref = trainer.init(rng.PRNGKey(3, device=device))
    ref_metrics = []
    for _ in range(NCCL_STEPS):
        ref, m = trainer.train_step(ref)
        ref_metrics.append(m)
    state = mesh_lib.shard_train_state(trainer.init(rng.PRNGKey(3, device=device)), mesh)
    step = mesh_lib.make_distributed_train_step(trainer, mesh)
    torch.cuda.synchronize()
    fdm_cuda.reset_launch_counts()
    metrics = []
    for _ in range(NCCL_STEPS):
        state, m = step(state)
        metrics.append(m)
    torch.cuda.synchronize()
    launches = dict(fdm_cuda.launch_counts)
    diff = _tree_diff(convert.train_state_to_numpy(state, trainer),
                      convert.train_state_to_numpy(ref, trainer))
    same_metrics = all(torch.equal(a[k], b[k]) for a, b in zip(metrics, ref_metrics) for k in a)
    return {"launches": launches, "diff": diff, "same_metrics": same_metrics,
            "backend": torch.distributed.get_backend()}


def _rank_nccl_graphs(rank, mesh, device, out) -> dict:
    """(c), then phase 15 (a) in the same rank (one start-up for both)."""
    nccl = _rank_nccl(rank, mesh, device, out)
    return {**nccl, "graphs": _rank_graphs(rank, mesh, device, out)}


RANK_JOBS = {"train": _rank_train, "nccl": _rank_nccl, "nccl_graphs": _rank_nccl_graphs,
             "graphs": lambda *a: _rank_graphs(*a)}
# Phase 15 (a)'s results when phase 10 (c) ran it.
NCCL_GRAPHS = {}


def rank_main(rank, world, job, out, backend, device) -> None:
    """A spawned rank of phase 10: joins the group (a FileStore under `out`,
    DIST_TIMEOUT on every collective) on `device` (None: the card
    runtime.initialize makes current, LOCAL_RANK = rank), runs RANK_JOBS[job]
    and writes its result to out/rank{rank}.json."""
    sys.path.insert(0, REPO)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from sbsim_tpu_torch.distributed import mesh as mesh_lib
    from sbsim_tpu_torch.distributed import runtime

    os.environ["LOCAL_RANK"] = str(rank)
    runtime.initialize(backend=backend, init_method=f"file://{out}/store", world_size=world,
                       rank=rank, timeout=DIST_TIMEOUT)
    try:
        if device is None:
            device = f"cuda:{torch.cuda.current_device()}"
        result = RANK_JOBS[job](rank, mesh_lib.make_mesh(), torch.device(device), out)
        result["device"] = device
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(result, f)
    finally:
        runtime.shutdown()


def _run_ranks(job, world, backend, device, out) -> list:
    """Spawns `world` ranks of `job`; fails if a rank fails or the deadline
    passes; returns the ranks' results."""
    from sbsim_tpu_torch.distributed import runtime

    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    try:
        runtime.spawn(rank_main, world, (job, out, backend, device), timeout=DIST_TIMEOUT)
    except RuntimeError as exc:
        fail(f"distributed {job} on {world} ranks ({backend}): {exc}")
    results = []
    for r in range(world):
        with open(f"{out}/rank{r}.json") as f:
            results.append(json.load(f))
    print(f"  ({job}) {world} ranks over {backend} on "
          f"{sorted({r['device'] for r in results})}: {time.time() - t0:.1f} s with start-up",
          flush=True)
    return results


def _max_abs(a, b) -> float:
    import numpy as np

    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.size else 0.0


def distributed_phase(envs, tag, ranks=DIST_RANKS, backend="gloo", with_graphs=True):
    """Phase 10: (a) the sharded train step over `ranks` ranks against one
    process, (c) NCCL at world size 1 (`with_graphs`: its rank runs phase
    15 (a) too), (d) the ranks' checkpoint restored in one process ((b),
    the sharded rollout, is timed warm by the scaling harness in phase
    11). With backend "gloo" every rank runs on DEVICE
    (several ranks share the card); with "nccl", rank r on card r. Returns
    the launches of the ranks."""
    import tempfile

    import numpy as np
    from sbsim_tpu_torch import convert, rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.io.checkpoint import TrainCheckpointer

    t_start = time.time()
    device = DEVICE if backend == "gloo" else None
    launches = dict.fromkeys(COUNTED, 0)
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a) the sharded train step ---------------------------------
        results = _run_ranks("train", ranks, backend, device, f"{tmp}/train")
        env = envs["12zone"]
        trainer = _train_recipe(env)
        state = trainer.init(rng.PRNGKey(0, device=env.device))
        seed = trainer.seed_with_actions(state, schedule_policy.build_schedule_actions(env))
        for _ in range(DIST_SEED_STEPS):
            state, _ = seed(state)
        diff = _tree_diff(_undump(f"{tmp}/train/seeded.npz"),
                          _flat_tree(convert.train_state_to_numpy(state, trainer)))
        if diff:
            fail(f"(a) {ranks} ranks' seeding differs from one process in {diff}")
        ref_metrics = []
        for _ in range(DIST_TRAIN_STEPS):
            state, m = trainer.train_step(state)
            ref_metrics.append(m)
        got = _undump(f"{tmp}/train/trained.npz")
        want = _flat_tree(convert.train_state_to_numpy(state, trainer))
        errs = {
            "temp": _max_abs(got["env_states/temp"], want["env_states/temp"]),
            "replay_reward": _max_abs(got["replay/data/reward"], want["replay/data/reward"]),
            "param": max(_max_abs(got[k], want[k]) for k in want
                         if k.startswith(("sac/actor_params/", "sac/critic_params/"))),
            "log_alpha": _max_abs(got["sac/log_alpha"], want["sac/log_alpha"]),
            "reward": max(abs(m["reward_mean"] - float(r["reward_mean"]))
                          for res in results for m, r in zip(res["metrics"], ref_metrics)),
        }
        exact = [k for k in ("sac/step", "replay/size", "replay/insert_index", "env_steps",
                             "rng") if not np.array_equal(got[k], want[k])]
        if exact or any(errs[k] > DIST_TOL[k] for k in DIST_TOL):
            fail(f"(a) {ranks} ranks after {DIST_TRAIN_STEPS} train steps: {errs} against "
                 f"{DIST_TOL}; unequal {exact}")
        if any(res["metrics"] != results[0]["metrics"] for res in results):
            fail("(a) the ranks' metrics differ")
        steps = DIST_SEED_STEPS + DIST_TRAIN_STEPS
        for r, res in enumerate(results):
            if res["launches"] != {k: (steps if k == "fdm_jacobi" else 0) for k in COUNTED}:
                fail(f"(a) rank {r} launches {res['launches']}, want {steps} fdm_jacobi")
            launches["fdm_jacobi"] += res["launches"]["fdm_jacobi"]
        step_ms = [statistics.median(res["step_ms"][2:]) for res in results]
        if backend == "nccl":
            diffs = [res["eager"]["diff"] for res in results]
            if any(diffs):
                fail(f"(a) the captured {ranks}-rank train steps differ from the eager ones: "
                     f"{diffs}")
            eager_ms = [statistics.median(res["eager"]["step_ms"][2:]) for res in results]
            print(f" (a) {ranks} NCCL ranks: the captured train steps (state and metrics) "
                  f"bitwise the eager per-rank steps; train step median per rank: eager "
                  f"{[f'{ms:.3f}' for ms in eager_ms]} ms, graph "
                  f"{[f'{ms:.3f}' for ms in step_ms]} ms (CUDA events; the all-reduces below "
                  f"timed on the eager run) {tag}", flush=True)
        # A train step's all-reduces: its reward mean, then the update's
        # critic and actor gradients (with their statistics).
        calls = len(results[0]["all_reduce_ms"]) // DIST_TRAIN_STEPS
        upd = [statistics.median(sum(res["all_reduce_ms"][i * calls + 1:(i + 1) * calls])
                                 for i in range(2, DIST_TRAIN_STEPS)) for res in results]
        print(f" (a) sharded train step, sb1 12 zones n_envs={DIST_ENVS} ({results[0]['rows']} "
              f"per rank), batch 256, {ranks} ranks over {backend}: {DIST_SEED_STEPS} seeding "
              f"steps bitwise one process (env states, iteration counts, replay); after "
              f"{DIST_TRAIN_STEPS} train steps max |d| {errs} (limits {DIST_TOL}), sac.step "
              f"{int(got['sac/step'])}, replay {int(got['replay/size'])}/env; K2 launches per "
              f"rank {[res['launches']['fdm_jacobi'] for res in results]}; train step median "
              f"per rank {[f'{ms:.3f}' for ms in step_ms]} ms -> "
              f"{DIST_ENVS / max(step_ms) * 1e3:,.0f} env-steps/s; {calls} all-reduces per "
              f"train step ({results[0]['all_reduce_floats'][:calls]} floats), median per "
              f"rank {[f'{ms:.3f}' for ms in upd]} ms per update (CUDA events) {tag}",
              flush=True)

        # ---- (d) the ranks' checkpoint in one process --------------------
        ckpt = TrainCheckpointer(f"{tmp}/train/ckpt", trainer)
        restored = ckpt.restore(trainer.init(rng.PRNGKey(1, device=env.device)))
        diff = _tree_diff(_flat_tree(convert.train_state_to_numpy(restored, trainer)), got)
        if diff or ckpt.steps() != [DIST_TRAIN_STEPS]:
            fail(f"(d) the {ranks} ranks' checkpoint {ckpt.steps()} restores with {diff}")
        cont, m = trainer.train_step(restored)
        if cont.env_steps != restored.env_steps + DIST_ENVS or not np.isfinite(
                float(m["reward_mean"])):
            fail(f"(d) resuming gave env_steps {cont.env_steps}, reward {float(m['reward_mean'])}")
        print(f" (d) the {ranks} ranks' checkpoint restored in one process bitwise the gathered "
              f"state; one more train step: env_steps {restored.env_steps} -> {cont.env_steps}",
              flush=True)

        # ---- (c) NCCL at world size 1 -------------------------------------
        (res,) = _run_ranks("nccl_graphs" if with_graphs else "nccl", 1, "nccl", None,
                            f"{tmp}/nccl")
        NCCL_GRAPHS.update(res.get("graphs", {}))
        if res["diff"] or not res["same_metrics"] or res["backend"] != "nccl":
            fail(f"(c) the one-rank NCCL step differs from train_step: {res['diff']}, "
                 f"metrics equal {res['same_metrics']}")
        if res["launches"] != {k: (NCCL_STEPS if k == "fdm_jacobi" else 0) for k in COUNTED}:
            fail(f"(c) launches {res['launches']}")
        launches["fdm_jacobi"] += res["launches"]["fdm_jacobi"]
        print(f" (c) one-rank NCCL group: {NCCL_STEPS} make_distributed_train_step steps "
              f"bitwise trainer.train_step (state and metrics); K2 launches "
              f"{res['launches']['fdm_jacobi']}", flush=True)
    print(f"  phase 10 in {time.time() - t_start:.1f} s {tag}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the scripts beside the package (sbsim_tpu_torch/benchmarks)
# ---------------------------------------------------------------------------

# (a) sac_sb1_train at 12 zones, its recipe cut to a few hundred seeding
# steps and 100 train steps.
CURVE_ARGS = ["--n-envs", "64", "--seed-steps", "150", "--chunk", "25", "--train-steps", "50",
              "--eval-every", "25", "--eval-envs", "4"]
JAX_CURVE = "artifacts/sac_sb1_12zone_curve.json"
# (a)'s captured run of sac_sb1_train.main (phase 15 (d) holds it against
# the run op by op).
CURVE_RUN = {}
# (b) the scaling harness: rows of 1 and 2 gloo ranks on the one card (with
# --ranks N --backend nccl: 1, 2, ..., N cards).
SCALING_ARGS = ["--batch-per-device", "1024", "--steps", "8", "--repeats", "5"]
# (c) the first threshold crossing (step, zones) of the 126-room day on the
# transposed plan, where the JAX package's per-env step run op by op (no
# FMA contraction, bitwise the port's) leaves the exact host too
# (tests/test_torch_opbyop.py); the jitted JAX package holds the day.
PARITY126_WITNESS = (143, (28,))
# (e) the schedule search on a small plan, one candidate with fewer rounds
# than the plan's auto-sized 16, at a budget that admits it, so it is
# recorded.
SEARCH_ARGS = ["--rooms-x", "2", "--rooms-y", "2", "--room-cvs", "10", "--rounds", "8",
               "--seeds", "5", "--budget", "1.0", "--write-cache"]


# The draw kernel's launches that `_counted` has seen, and phase 14 (d)'s.
DRAWN = {"launches": 0}


def _counted(label, fn, want, sync_free=False, draws=None):
    """fn() with the launch counts set to 0 just before and read just after;
    fails unless they equal `want` (kernel -> launches, others 0) and, with
    `draws`, unless the draw kernel's launches equal `draws` (kind ->
    launches, others 0). With `sync_free` fn runs under
    torch.cuda.set_sync_debug_mode("error")."""
    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.physics import fdm_cuda

    _sync()
    fdm_cuda.reset_launch_counts()
    rng.reset_launch_counts()
    with _no_host_sync() if sync_free else contextlib.nullcontext():
        out = fn()
    _sync()
    counts = dict(fdm_cuda.launch_counts)
    if counts != {k: want.get(k, 0) for k in COUNTED}:
        fail(f"{label}: launch counts {counts}, want {want}")
    drawn = {k: n for k, n in rng.launch_counts.items() if n}
    if draws is not None and drawn != draws:
        fail(f"{label}: draw launches {drawn}, want {draws}")
    DRAWN["launches"] += sum(drawn.values())
    return out, counts


def _curve_launches(n_eval) -> int:
    """K2 launches of sac_sb1_train.main at CURVE_ARGS (n_eval steps a day)."""
    from sbsim_tpu_torch.benchmarks import sac_sb1_train

    args = sac_sb1_train.parse_args(CURVE_ARGS)
    evals = 2 + args.train_steps // args.eval_every + 2  # baselines, untrained, curve, held out
    return (args.seed_steps // args.chunk) * args.chunk + args.train_steps + evals * n_eval


def script_curve(tmp, tag) -> dict:
    """(a): sac_sb1_train.main on the cut recipe through K2; the JSON has
    every key of the JAX package's curve and finite returns; the schedule
    baseline's rollout through K2 bitwise its rollout through the plain
    versions."""
    import math

    import numpy as np
    import torch
    from sbsim_tpu_torch import convert, rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.benchmarks import sac_sb1_train

    args = sac_sb1_train.parse_args(CURVE_ARGS)
    env, _ = sac_sb1_train.make_env(False, torch.device(DEVICE))
    n_eval = env.steps_per_episode
    want = _curve_launches(n_eval)
    out = os.path.join(tmp, "curve.json")
    t0 = time.time()
    result, counts = _counted("curve12", lambda: sac_sb1_train.main(CURVE_ARGS + ["--out", out]),
                              {"fdm_jacobi": want})
    seconds = time.time() - t0
    CURVE_RUN.update(result=result, seconds=seconds)
    with open(os.path.join(REPO, JAX_CURVE)) as f:
        missing = sorted(set(json.load(f)) - set(result))
    returns = [result[k] for k in ("schedule_baseline_return", "untrained_return",
                                   "final_return", "best_return", "best_return_holdout_seed",
                                   "schedule_return_holdout_seed")]
    returns += [c["eval_return"] for c in result["curve"]]
    if missing or not all(math.isfinite(r) for r in returns) or len(result["curve"]) != 3:
        fail(f"curve12: keys missing {missing}, returns {returns}")
    table = schedule_policy.build_schedule_actions(env)

    def baseline(plain):
        with plain_kernels() if plain else contextlib.nullcontext():
            states, rewards = sac_sb1_train.rollout(env, table, rng.PRNGKey(7), n_eval,
                                                             args.eval_envs)
        return convert.env_state_to_numpy(states), rewards.cpu().numpy()

    (got, got_r), _ = _counted("curve12 baseline", lambda: baseline(False),
                               {"fdm_jacobi": n_eval})
    want_s, want_r = baseline(True)
    _check_equal_trees("curve12 schedule baseline", got, want_s)
    if not np.array_equal(got_r, want_r):
        fail("curve12: the schedule baseline's rewards through K2 differ from the plain run's")
    print(f"  (a) curve12: sac_sb1_train.main {' '.join(CURVE_ARGS)} through K2 (launches "
          f"{counts['fdm_jacobi']}) in {seconds:.1f} s: schedule baseline "
          f"{result['schedule_baseline_return']}, untrained {result['untrained_return']}, curve "
          f"{[round(c['eval_return'], 4) for c in result['curve']]}, best on the held-out seed "
          f"{result['best_return_holdout_seed']} (schedule {result['schedule_return_holdout_seed']}); "
          f"every key of {JAX_CURVE}; the schedule baseline's {n_eval}-step rollout through K2 "
          f"bitwise the plain versions' (states and rewards) {tag}", flush=True)
    return {"fdm_jacobi": counts["fdm_jacobi"] + n_eval}


def script_scaling(tmp, tag, rank_counts, backend) -> dict:
    """(b): the scaling harness, warm ranks; its rows bitwise one process
    (the harness exits non-zero otherwise), launches per rank (1 + repeats)
    x steps of K1."""
    from sbsim_tpu_torch.benchmarks import scaling

    argv = SCALING_ARGS + ["--devices", *map(str, rank_counts), "--backend", backend,
                           "--out", os.path.join(tmp, "scaling.json")]
    args = scaling.parse_args(argv)
    try:
        payload = scaling.main(argv)
    except (RuntimeError, SystemExit) as exc:
        fail(f"scaling harness: {exc}")
    per_rank = (1 + args.repeats) * args.steps
    launches = 0
    for row in payload["results"]:
        for r, counts in enumerate(row["launches"]):
            if counts != {k: (per_rank if k == "fdm_cheby" else 0) for k in COUNTED}:
                fail(f"scaling at {row['devices']} ranks: rank {r} launches {counts}")
            launches += counts["fdm_cheby"]
        print(f"  (b) scaling, 12 zones pallas_cheby, {row['devices']} rank(s) over {backend} x "
              f"{args.batch_per_device} envs on {sorted(set(row['rank_devices']))}: "
              f"one untimed call, then {args.repeats} calls of {args.steps} steps, slowest rank "
              f"{[round(ms, 3) for ms in row['slowest_rank_ms']]} ms -> best "
              f"{row['env_steps_per_sec']:,.1f}, median {row['median_env_steps_per_sec']:,.1f} "
              f"env-steps/s ({row['per_device']:,.1f} per rank); rows bitwise one process's "
              f"step_batched; K1 launches per rank {per_rank}; {row['seconds_with_start_up']} s "
              f"with start-up {tag}", flush=True)
    if len(payload["results"]) != len(rank_counts):
        fail(f"scaling: {len(payload['results'])} rows for {rank_counts} ranks")
    print(f"  (b) {json.dumps(payload['summary'])} {tag}", flush=True)
    return {"fdm_cheby": launches}


def script_parity126(tag) -> dict:
    """(c): fullscale_parity_check.parity_day on the transposed 126-room
    plan, a whole day through K2 unstaged beside the exact host. The day
    passes when the tracker holds it all day with no threshold crossing
    (the jitted JAX package's day); otherwise the tracker must hold it
    strictly up to its first crossing, and that crossing must be
    PARITY126_WITNESS, where the JAX package run op by op leaves the host
    too."""
    import math

    import numpy as np
    import torch
    from sbsim_tpu_torch.benchmarks import fullscale_parity_check as fpc
    from sbsim_tpu_torch.envs import building_env, exact_host

    env = building_env.BuildingEnv(fpc.parity_config("auto"), device=torch.device(DEVICE))
    host = exact_host.ExactHostSimulator(env)
    if env.geom.shape != (189, 124) or not host._plan_transposed or not np.array_equal(
            host._diffusers64.astype(np.float32), np.asarray(env.geom.diffusers)):
        fail(f"parity126: geometry {env.geom.shape}, host transposed {host._plan_transposed}, "
             "or the host's diffusers differ from the geometry's")
    t0 = time.time()
    day, counts = _counted(
        "parity126", lambda: fpc.parity_day(env, fpc.STEPS, log=lambda m: print(f"    {m}", flush=True)),
        {"fdm_jacobi": fpc.STEPS})
    seconds = time.time() - t0
    if not all(math.isfinite(d) for d in day.drifts):
        fail("parity126: the device fields are not finite")
    first = day.report.crossings[0] if day.report.crossings else None
    if day.held:
        verdict = "held every step: modes identical, no crossing"
    elif first is None or first[:2] != PARITY126_WITNESS or not all(
            day.modes_equal[:first[0]]) or day.error_step < first[0]:
        fail(f"parity126: the tracker failed at step {day.error_step} ({day.error}); first "
             f"crossing {first}, the JAX package op by op crosses at {PARITY126_WITNESS}")
    else:
        after = day.drifts[first[0]:]
        verdict = (f"held strictly through step {first[0] - 1} (largest drift "
                   f"{max(day.drifts[:first[0]]):.6e} K); zones {list(first[1])} cross the "
                   f"heating setpoint at step {first[0]} (margin {first[2]:.3e} K), as the JAX "
                   f"package run op by op does (PARITY126_WITNESS); the tracker fails at step "
                   f"{day.error_step}; after the crossing modes differ on "
                   f"{day.modes_equal.count(False)} steps, drift up to {max(after):.6e} K, last "
                   f"step's {after[-1]:.6e} K")
    print(f"  (c) parity126 (126 zones, 189 x 124 transposed, host transposed with the "
          f"geometry's diffusers; {fpc.STEPS} steps through fdm_jacobi unstaged, launches "
          f"{counts['fdm_jacobi']}, {seconds:.1f} s; the jitted JAX package's day "
          f"{fpc.JAX_MAX_DRIFT_K:.6e} K, budget {exact_host.DRIFT_BUDGET} K): {verdict} {tag}",
          flush=True)
    return {"fdm_jacobi": counts["fdm_jacobi"]}


def script_shuffle12(tag) -> dict:
    """(d): mix32 swap convection against the exact shuffle through
    conv_rounds_sweep's helpers: through K2 within KS_LIMIT / DMEAN_LIMIT,
    through K1 within the witness tolerances of K1_WITNESS."""
    import torch
    from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs

    dev = torch.device(DEVICE)
    cfg = crs.base_config()
    swap, launches = {}, dict.fromkeys(COUNTED, 0)
    for kname, solver in (("fdm_jacobi", "pallas_env"), ("fdm_cheby", "pallas_cheby")):
        (swap[kname], env), counts = _counted(
            f"shuffle12 through {kname}", lambda s=solver: crs.run_swap(cfg, dev, solver=s),
            {kname: crs.N_STEPS})
        launches[kname] += counts[kname]
    t0 = time.perf_counter()
    exact = crs.run_exact(cfg, dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / (crs.SEEDS * crs.N_STEPS)
    ks, dmean = crs.worst_stats(env, swap["fdm_jacobi"], exact)
    if ks > KS_LIMIT or dmean > DMEAN_LIMIT:
        fail(f"shuffle12 through fdm_jacobi: worst zone KS {ks} (limit {KS_LIMIT}), worst "
             f"zone-mean difference {dmean} K (limit {DMEAN_LIMIT})")
    ks1, dmean1 = crs.worst_stats(env, swap["fdm_cheby"], exact)
    if abs(ks1 - K1_WITNESS[0]) > WITNESS_KS_TOL or abs(dmean1 - K1_WITNESS[1]) > WITNESS_DMEAN_TOL:
        fail(f"shuffle12 through fdm_cheby: worst zone KS {ks1}, worst zone-mean difference "
             f"{dmean1} K, against the JAX kernel's {K1_WITNESS} (tolerances "
             f"{WITNESS_KS_TOL}, {WITNESS_DMEAN_TOL} K)")
    _, solver_dmean = crs.worst_stats(env, swap["fdm_cheby"], swap["fdm_jacobi"])
    print(f"  (d) shuffle12 ({crs.N_STEPS} steps of mix32 swap convection at B={crs.SEEDS} "
          f"against the exact shuffle, conv_rounds_sweep.run_swap / run_exact / worst_stats): "
          f"through fdm_jacobi (launches {launches['fdm_jacobi']}) worst zone KS {ks:.4f} "
          f"(limit {KS_LIMIT}), worst zone-mean difference {dmean:.4f} K (limit "
          f"{DMEAN_LIMIT}); through fdm_cheby (launches {launches['fdm_cheby']}) KS "
          f"{ks1:.4f}, zone-mean difference {dmean1:.4f} K (the JAX kernel's "
          f"{K1_WITNESS[0]:.4f}, {K1_WITNESS[1]:.4f} K, within {WITNESS_KS_TOL}, "
          f"{WITNESS_DMEAN_TOL} K), fdm_cheby against fdm_jacobi on the same keys "
          f"{solver_dmean:.4f} K; exact-host step {host_ms:.3f} ms (host clock, mean) {tag}",
          flush=True)
    return launches


def script_search(tmp, tag) -> dict:
    """(e): conv_schedule_search with one candidate, writing into a copy of
    the schedule cache, which presets.sb1_config then reads back."""
    import shutil

    from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs
    from sbsim_tpu_torch.benchmarks import conv_schedule_search
    from sbsim_tpu_torch.core.geometry import make_synthetic_office_plan
    from sbsim_tpu_torch.envs import presets
    from sbsim_tpu_torch.scenario import conv_cache

    args = conv_schedule_search.parse_args(SEARCH_ARGS)
    cache = os.path.join(tmp, "conv_schedules.json")
    shutil.copy(conv_cache._CACHE_PATH, cache)
    packaged, conv_cache._CACHE_PATH = conv_cache._CACHE_PATH, cache
    try:
        t0 = time.time()
        result, counts = _counted(
            "conv search", lambda: conv_schedule_search.main(SEARCH_ARGS),
            {"fdm_jacobi": (1 + len(args.rounds) * len(args.seeds)) * crs.N_STEPS})
        seconds = time.time() - t0
        plan = make_synthetic_office_plan(args.rooms_x, args.rooms_y, room_cvs=args.room_cvs)
        conv = presets.sb1_config(floor_plan=plan).convection
    finally:
        conv_cache._CACHE_PATH = packaged
    candidate = result["rows"][1]
    if (result["verdict"]["recommendation"] != candidate["candidate"]
            or (conv.rounds, conv.seed) != (candidate["rounds"], candidate["seed"])
            or conv_cache.lookup(plan) is not None):
        fail(f"conv search: verdict {result['verdict']}, presets read rounds {conv.rounds} seed "
             f"{conv.seed} from the copy; the packaged cache has the plan: "
             f"{conv_cache.lookup(plan) is not None}")
    print(f"  (e) conv search ({result['verdict']['plan']}, {len(result['rows']) - 1} candidate, "
          f"through fdm_jacobi, launches {counts['fdm_jacobi']}, {seconds:.1f} s): auto default "
          f"({result['rows'][0]['rounds']} rounds) KS {result['rows'][0]['worst_zone_ks']}, "
          f"{candidate['candidate']} KS {candidate['worst_zone_ks']}, zone-mean difference "
          f"{candidate['worst_zone_dmean_K']} K; recorded in a copy of the cache (key "
          f"{result['cache_key']}), read back by presets.sb1_config: rounds {conv.rounds}, seed "
          f"{conv.seed}; the packaged cache untouched {tag}", flush=True)
    return counts


def scripts_phase(tag, rank_counts=(1, 2), backend="gloo", only=None) -> dict:
    """Phase 11: (a) the learning run, (b) the scaling harness, (c) the
    126-room parity day, (d) shuffle12 and (e) the schedule search, each
    through its script's functions; returns their launches. `only` names
    the parts to run (default all)."""
    import tempfile

    t_start = time.time()
    launches = dict.fromkeys(COUNTED, 0)
    with tempfile.TemporaryDirectory() as tmp:
        parts = {"a": lambda: script_curve(tmp, tag),
                 "b": lambda: script_scaling(tmp, tag, rank_counts, backend),
                 "c": lambda: script_parity126(tag),
                 "d": lambda: script_shuffle12(tag),
                 "e": lambda: script_search(tmp, tag)}
        for name, fn in parts.items():
            if only is None or name in only:
                for kname, n in fn().items():
                    launches[kname] += n
    print(f"  phase 11 in {time.time() - t_start:.1f} s {tag}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the study scripts (sbsim_tpu_torch/benchmarks)
# ---------------------------------------------------------------------------

# (a) The exact_vs_exact row of benchmarks/conv_fullscale_null.py at 126
# rooms (worst zone KS, worst zone-mean difference K), as the JAX script
# prints it (4 digits) on the CPU. The exact host is host numpy, bitwise the
# JAX package's (tests/test_torch_scripts.py), so the port's row equals it.
NULL_ARTIFACT = "artifacts/CONV_FULLSCALE_NULL_r05.json"
NULL_EXACT_WITNESS = (0.0729, 0.023)
# (b), (c): the rows of benchmarks/conv_designed_sweep.py and
# conv_schedule_sweep.py (CONV_SWEEP_VARIANTS=16:5,10:101) on the CPU, the
# swap path through the XLA Jacobi solve (equal to artifacts/CONV_DESIGNED_r04.json
# and CONV_SCHEDULES_r04.json); the port's through K2 must lie within
# WITNESS_KS_TOL and WITNESS_DMEAN_TOL of each.
DESIGNED_WITNESS = {
    "control_seed101_r10": (0.0957, 0.0508), "d8_balanced_diag": (0.3036, 0.1418),
    "d8_long_axes": (0.4809, 0.2302), "d8_winner_motif": (0.2462, 0.11),
    "d8_max_disp": (0.3099, 0.1378), "d10_winner_motif": (0.1148, 0.0455),
}
SCHEDULE_VARIANTS = "16:5,10:101"
SCHEDULE_WITNESS = {(16, 5): (0.1339, 0.0604), (10, 101): (0.0957, 0.0508)}
# (d) the SAC smokes cut to a few dozen seeding steps, 100 train steps and
# one evaluation; the sb1 smoke's schedule rollout held bitwise over
# SB1_BASELINE_STEPS steps.
SMOKE_ARGS = ["--seed-steps", "30", "--train-steps", "100", "--eval-every", "100"]
SB1_BASELINE_STEPS = 48
# (e) the scaling decomposition at phase 11 (b)'s configuration.
DECOMP_ARGS = ["--batch-per-device", "1024", "--steps", "8", "--repeats", "3",
               "--solver", "pallas_cheby"]


class _recorded_swaps:
    """Within the block, every conv_rounds_sweep.run_swap call is recorded
    as (args, kwargs, fields); `check` then runs each again under the plain
    versions and fails unless the fields are bitwise equal."""

    def __enter__(self):
        from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs

        self.calls, self.saved = [], crs.run_swap

        def run_swap(*args, **kwargs):
            fields, env = self.saved(*args, **kwargs)
            self.calls.append((args, kwargs, fields))
            return fields, env

        crs.run_swap = run_swap
        return self

    def __exit__(self, *exc):
        from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs

        crs.run_swap = self.saved

    def check(self, label) -> None:
        import numpy as np

        for args, kwargs, fields in self.calls:
            with plain_kernels():
                want, _ = self.saved(*args, **kwargs)
            if not np.array_equal(fields, want):
                fail(f"{label}: a swap draw through K2 differs from the plain versions' by "
                     f"{float(np.abs(fields - want).max())} K")


def _near(got, want) -> bool:
    return (abs(got[0] - want[0]) <= WITNESS_KS_TOL
            and abs(got[1] - want[1]) <= WITNESS_DMEAN_TOL)


def study_null(tmp, tag) -> dict:
    """(a): conv_fullscale_null at the full 126-room plan, both swap draws
    through K2 bitwise the plain versions', exact_vs_exact the JAX
    script's row."""
    from sbsim_tpu_torch.benchmarks import conv_fullscale_null as null
    from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs

    t0 = time.time()
    with _recorded_swaps() as swaps:
        result, counts = _counted("null126", lambda: null.main(
            ["--out", os.path.join(tmp, "null.json")]), {"fdm_jacobi": 2 * crs.N_STEPS})
    seconds = time.time() - t0
    swaps.check("null126")
    ee = result["exact_vs_exact"]
    got = (round(ee["worst_zone_ks"], 4), round(ee["worst_zone_dmean_K"], 4))
    if len(swaps.calls) != 2 or got != NULL_EXACT_WITNESS:
        fail(f"null126: {len(swaps.calls)} swap draws; exact_vs_exact {got}, the JAX "
             f"script's {NULL_EXACT_WITNESS}")
    with open(os.path.join(REPO, NULL_ARTIFACT)) as f:
        jax_rows = json.load(f)
    rows = "; ".join(
        f"{k} KS {result[k]['worst_zone_ks']:.4f} dmean {result[k]['worst_zone_dmean_K']:.4f} K "
        f"(r05: {jax_rows[k]['worst_zone_ks']:.4f}, {jax_rows[k]['worst_zone_dmean_K']:.4f})"
        for k in ("exact_vs_exact", "swap_vs_swap", "swap_vs_exact_auto"))
    print(f"  (a) null126 ({result['plan']}, {crs.SEEDS} envs x {crs.N_STEPS} steps, two swap "
          f"draws through fdm_jacobi, launches {counts['fdm_jacobi']}, each bitwise the plain "
          f"versions'; exact_vs_exact the JAX script's {NULL_EXACT_WITNESS}; {seconds:.1f} "
          f"s): {rows} {tag}", flush=True)
    return counts


def study_sweep(tmp, tag, which) -> dict:
    """(b) conv_designed_sweep, all six rows, or (c) conv_schedule_sweep at
    SCHEDULE_VARIANTS: each swap run through K2 bitwise the plain
    versions', each row within the witness tolerances of the JAX
    script's."""
    from sbsim_tpu_torch.benchmarks import conv_designed_sweep as cds
    from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs
    from sbsim_tpu_torch.benchmarks import conv_schedule_sweep as css

    out = os.path.join(tmp, f"{which}.json")
    if which == "designed":
        label, main = "(b) designed12", lambda: cds.main(["--out", out])
        n_rows, witness = 1 + len(cds.DESIGNS), DESIGNED_WITNESS
        key = lambda row: row["name"]
    else:
        label, main = "(c) schedules12", lambda: css.main(
            ["--variants", SCHEDULE_VARIANTS, "--out", out])
        n_rows, witness = len(css.parse_variants(SCHEDULE_VARIANTS)), SCHEDULE_WITNESS
        key = lambda row: (row["rounds"], row["schedule_seed"])
    t0 = time.time()
    with _recorded_swaps() as swaps:
        result, counts = _counted(label, main, {"fdm_jacobi": n_rows * crs.N_STEPS})
    seconds = time.time() - t0
    swaps.check(label)
    parts = []
    for row in result["rows"]:
        got, want = (row["worst_zone_ks"], row["worst_zone_dmean_K"]), witness[key(row)]
        if not _near(got, want):
            fail(f"{label} {key(row)}: KS, dmean {got}, the JAX script's {want} (tolerances "
                 f"{WITNESS_KS_TOL}, {WITNESS_DMEAN_TOL} K)")
        parts.append(f"{key(row)} {got[0]:.4f} / {got[1]:.4f} K (JAX {want[0]:.4f} / "
                     f"{want[1]:.4f})")
    if len(result["rows"]) != n_rows:
        fail(f"{label}: {len(result['rows'])} rows, want {n_rows}")
    print(f"  {label} ({n_rows} rows through fdm_jacobi, launches {counts['fdm_jacobi']}, "
          f"each bitwise the plain versions'; worst zone KS / zone-mean difference within "
          f"{WITNESS_KS_TOL} / {WITNESS_DMEAN_TOL} K of the JAX script's; {seconds:.1f} s): "
          f"{'; '.join(parts)} {tag}", flush=True)
    return counts


def _finite_numbers(tree) -> bool:
    import math

    if isinstance(tree, dict):
        return all(_finite_numbers(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite_numbers(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def study_sac(tag) -> dict:
    """(d): sac_smoke and sac_sb1_smoke on the cut recipe through K2, every
    number finite; each smoke's schedule-table rollout through K2 bitwise
    its rollout through the plain versions (states and rewards)."""
    import torch
    from sbsim_tpu_torch import convert, rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.benchmarks import sac_sb1_smoke, sac_sb1_train, sac_smoke
    from sbsim_tpu_torch.envs import building_env, presets

    total = dict.fromkeys(COUNTED, 0)
    for module, cfg, steps, envs in (
            (sac_smoke, presets.two_zone_test_config(num_days_in_episode=1),
             sac_smoke.N_EVAL, 4),
            (sac_sb1_smoke, presets.sb1_config(num_days_in_episode=1), SB1_BASELINE_STEPS,
             2)):
        name = module.__name__.rsplit(".", 1)[1]
        args = module.parse_args(SMOKE_ARGS)
        evals = args.train_steps // args.eval_every
        want = args.seed_steps + args.train_steps + (
            (3 + evals) * module.N_EVAL if module is sac_smoke else (1 + evals) * module.N_EVAL)
        t0 = time.time()
        result, counts = _counted(name, lambda: module.main(SMOKE_ARGS), {"fdm_jacobi": want})
        seconds = time.time() - t0
        if not _finite_numbers(result) or len(result["curve"]) != evals:
            fail(f"{name}: {result}")
        env = building_env.BuildingEnv(cfg, device=torch.device(DEVICE))
        table = schedule_policy.build_schedule_actions(env)

        def baseline(plain):
            with plain_kernels() if plain else contextlib.nullcontext():
                states, rewards = sac_sb1_train.rollout(env, table, rng.PRNGKey(123),
                                                                 steps, envs)
            return convert.env_state_to_numpy(states), rewards

        (got, got_r), _ = _counted(f"{name} baseline", lambda: baseline(False),
                                   {"fdm_jacobi": steps})
        want_s, want_r = baseline(True)
        _check_equal_trees(f"{name} schedule rollout", got, want_s)
        if not torch.equal(got_r, want_r):
            fail(f"{name}: the schedule rollout's rewards through K2 differ from the plain "
                 "run's")
        if module is sac_smoke and float(torch.mean(got_r.sum(dim=0))) != result[
                "schedule_return"]:
            fail(f"sac_smoke: schedule return {result['schedule_return']} is not its "
                 "rollout's")
        curve = [(c["step"], round(c["eval_return"], 4)) for c in result["curve"]]
        print(f"  (d) {name} ({' '.join(SMOKE_ARGS)}, through fdm_jacobi, launches "
              f"{counts['fdm_jacobi']}, {seconds:.1f} s): "
              + ", ".join(f"{k} {round(v, 4)}" for k, v in result.items()
                          if isinstance(v, float))
              + f", curve {curve}; every number finite; the schedule table's {steps}-step "
              f"rollout at {envs} envs through K2 bitwise the plain versions' (states and "
              f"rewards) {tag}", flush=True)
        total["fdm_jacobi"] += counts["fdm_jacobi"] + steps
    return total


def study_decomp(tmp, tag, ranks, backend) -> dict:
    """(e): scaling_decomp at phase 11 (b)'s configuration over `ranks`
    ranks: every row bitwise one process (the script exits non-zero
    otherwise), K1 launches per rank (1 + repeats) x steps; the rates and
    the four taxes."""
    from sbsim_tpu_torch.benchmarks import scaling_decomp

    argv = DECOMP_ARGS + ["--ranks", str(ranks), "--backend", backend,
                          "--out", os.path.join(tmp, "decomp.json")]
    args = scaling_decomp.parse_args(argv)
    t0 = time.time()
    try:
        payload = scaling_decomp.main(argv)
    except (RuntimeError, SystemExit) as exc:
        fail(f"scaling decomposition: {exc}")
    seconds = time.time() - t0
    per_rank = (1 + args.repeats) * args.steps
    launches = 0
    for name, row in payload["rows"].items():
        for r, counts in enumerate(row["launches"]):
            if counts != {k: (per_rank if k == "fdm_cheby" else 0) for k in COUNTED}:
                fail(f"scaling decomposition {name}: rank {r} launches {counts}")
            launches += counts["fdm_cheby"]
        print(f"  (e) {name}: {row['devices']} rank(s) x {row['batch'] // row['devices']} envs "
              f"on {sorted(set(row['rank_devices']))}, slowest rank "
              f"{[round(ms, 3) for ms in row['slowest_rank_ms']]} ms per {args.steps} steps -> "
              f"best {row['env_steps_per_sec']:,.1f}, median "
              f"{row['median_env_steps_per_sec']:,.1f} env-steps/s; rows bitwise one "
              f"process's step_batched {tag}", flush=True)
    print(f"  (e) scaling decomposition ({ranks} {backend} ranks, 12 zones pallas_cheby, "
          f"{args.batch_per_device} envs per rank, {seconds:.1f} s with start-up): "
          f"{json.dumps(payload['attribution'])} {tag}", flush=True)
    return {"fdm_cheby": launches}


def study_phase(tag, ranks=2, backend="gloo", only=None) -> dict:
    """Phase 12: (a) the 126-room convection null, (b) the designed and (c)
    the seeded schedule sweeps, (d) the two SAC smokes and (e) the scaling
    decomposition, each through its script's functions; returns their
    launches. `only` names the parts to run (default all)."""
    import tempfile

    t_start = time.time()
    launches = dict.fromkeys(COUNTED, 0)
    with tempfile.TemporaryDirectory() as tmp:
        parts = {"a": lambda: study_null(tmp, tag),
                 "b": lambda: study_sweep(tmp, tag, "designed"),
                 "c": lambda: study_sweep(tmp, tag, "schedules"),
                 "d": lambda: study_sac(tag),
                 "e": lambda: study_decomp(tmp, tag, ranks, backend)}
        for name, fn in parts.items():
            if only is None or name in only:
                for kname, n in fn().items():
                    launches[kname] += n
    print(f"  phase 12 in {time.time() - t_start:.1f} s {tag}", flush=True)
    return launches


# Phase 13: the port bench. (a), (b): `python -m sbsim_tpu_torch.bench` as a
# subprocess with a cut budget, (label, extra flags, solver, batch); (c),
# (d): its make_rollout in-process, (part, first step, steps), through the
# kernels and the plain versions ((d) crosses the tables' 592-step end).
BENCH_ARGS = ["--budget-sec", "20", "--max-repeats", "10"]
BENCH_RUNS = (("(a) 12zone", [], "pallas_cheby", 2048),
              ("(a) 126room", ["--full-scale"], "pallas_cheby", 512),
              ("(b) 12zone", ["--solver", "pallas_env"], "pallas_env", 2048))
BENCH_TIMEOUT = 300.0  # seconds, each bench process
BENCH_ROLLOUTS = (("(c)", 0, 8), ("(d)", 570, 32))


def bench_run(label, extra, solver, batch, card, tag) -> dict:
    """One bench process: exit 0, its last line's solver, batch and weather
    as asked, a passed solver check, finite positive rates from CUDA
    events on this card."""
    import math

    cmd = [sys.executable, "-m", "sbsim_tpu_torch.bench", *BENCH_ARGS, *extra]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"phase 13 {label}: the bench took more than {BENCH_TIMEOUT} s")
    seconds = time.time() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"phase 13 {label}: the bench exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    line = json.loads(lines[-1])
    rates = [line["value"], line["median"], *line["repeats"]]
    if (line["solver"], line["batch"], line["weather"]) != (solver, batch, "replay"):
        fail(f"phase 13 {label}: {line}")
    if not line["solver_check"]["passed"] or line["timing"] != "cuda_events":
        fail(f"phase 13 {label}: {line}")
    if line["card"] != card or not all(math.isfinite(r) and r > 0 for r in rates):
        fail(f"phase 13 {label}: {line}")
    check = line["solver_check"]
    print(f"  {label} bench {' '.join(BENCH_ARGS + extra)}: {solver} B={batch}, best "
          f"{line['best']:,.1f}, median {line['median']:,.1f} env-steps/s over "
          f"{len(line['repeats'])} repeats {line['repeats']}, plateaued {line['plateaued']}; "
          f"solver check max |dT| {check['max_abs_dtemp']:.4g} K, max |d reward| "
          f"{check['max_abs_dreward']:.3g}; {seconds:.1f} s with start-up "
          f"[{line['card']}]", flush=True)
    return line


def bench_rollouts(tag) -> dict:
    """(c), (d): the bench's make_rollout at each run's config and batch
    from the bench's reset, through the kernels (launches counted) and
    through the plain versions: states and mean rewards bitwise equal,
    fields finite; (d) from step 570 across the tables' end."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import bench, convert, rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.envs import building_env

    dev = torch.device(DEVICE)
    launches = dict.fromkeys(COUNTED, 0)
    for label, extra, solver, batch in BENCH_RUNS:
        env = building_env.BuildingEnv(bench.bench_config("--full-scale" in extra), device=dev)
        table = schedule_policy.build_schedule_actions(env)
        states0, _ = env.reset(rng.split(rng.PRNGKey(0, device=dev), batch))
        kname = kernel_of(env, solver)
        for part, start, steps in BENCH_ROLLOUTS:
            first = states0.replace(step_idx=torch.full_like(states0.step_idx, start))
            roll = bench.make_rollout(env, table, steps, solver)

            def run(plain):
                # The plain versions read back: they run op by op (`fn`),
                # the kernels through the captured program's first call.
                with plain_kernels() if plain else contextlib.nullcontext():
                    states, reward = (roll.eager if plain else roll)(first)
                return convert.env_state_to_numpy(states), reward

            what = f"phase 13 {part} {label[4:]} {solver} from step {start}"
            (got, got_r), _ = _counted(what, lambda: run(False), {kname: steps})
            want, want_r = run(True)
            _check_equal_trees(what, got, want)
            if not torch.equal(got_r, want_r):
                fail(f"{what}: mean reward {float(got_r)} through the kernel, "
                     f"{float(want_r)} through the plain versions")
            if not (np.isfinite(got["temp"]).all() and bool(torch.isfinite(got_r))
                    and (got["step_idx"] == start + steps).all()):
                fail(f"{what}: fields, reward or steps off")
            launches[kname] += steps
            print(f"  {part} {label[4:]} {solver} B={batch}: make_rollout of {steps} steps from "
                  f"step {start} (tables hold {env._table_steps}) through "
                  f"{kname} ({steps} launches) bitwise the plain versions' (states and mean "
                  f"reward {float(got_r):.6f}) {tag}", flush=True)
    return launches


def bench_phase(card, tag) -> dict:
    """Phase 13: the port bench on the card; returns the launches of (c)
    and (d) (the bench processes of (a) and (b) count their own)."""
    t_start = time.time()
    for label, extra, solver, batch in BENCH_RUNS:
        bench_run(label, extra, solver, batch, card, tag)
    launches = bench_rollouts(tag)
    print(f"  phase 13 in {time.time() - t_start:.1f} s {tag}", flush=True)
    return launches


# Phase 14: the JAX package's jitted programs as CUDA graphs
# (sbsim_tpu_torch/graphs.py), each replay held against the eager call from
# a clone of the same starting state. (a) the bench's make_rollout at
# BENCH_RUNS' configs for BENCH_ROLLOUTS' steps, then GRAPH_TIMED_CALLS
# timed calls of the bench's GRAPH_TIMED_STEPS steps per path; (b) the
# train12 recipe (GRAPH_ENVS envs, batch 256, replay 50,000) on a 1-day
# episode: GRAPH_SEED_CALLS seeding steps from step GRAPH_SEED_START (the
# second crosses the 288-step end inside a replay), then GRAPH_TRAIN_CALLS
# train steps whose update gate opens after GRAPH_SKIP_CALLS of them; (c)
# evaluate of a day (GRAPH_EVAL: steps, envs).
GRAPH_TIMED_CALLS = 5
GRAPH_TIMED_STEPS = 64
GRAPH_ENVS = 64
GRAPH_SEED_START = 286
GRAPH_SEED_CALLS = 4
GRAPH_SKIP_CALLS = 2
GRAPH_TRAIN_CALLS = 5
GRAPH_TRAIN_TIMED = 10
GRAPH_EVAL = (288, 4)


@contextlib.contextmanager
def _no_host_sync():
    """Within the block a synchronizing CUDA call raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _add(total, counts) -> None:
    for k, n in counts.items():
        total[k] += n


def _launch_profile(fn, per_call, label, tag):
    """torch.profiler over one call of fn (`per_call` env steps): wall and
    device-busy ms per env step, the device's idle share, kernels run on
    the device and the host's launch calls (cudaLaunchKernel,
    cudaGraphLaunch) per env step. Returns the figures (busy None where the
    profiler saw no device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.lower().startswith(("memcpy", "memset"))]
    host = lambda *names: sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
                              and e.name.startswith(names)) / per_call
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    out = {"wall_ms": wall_us / per_call / 1e3,
           "busy_ms": busy / per_call / 1e3 if kernels else None,
           "device_kernels": len(kernels) / per_call,
           "host_kernel_launches": host("cudaLaunchKernel", "cuLaunchKernel"),
           "host_graph_launches": host("cudaGraphLaunch")}
    busy_note = ("device busy not measured (the profiler recorded no device event)"
                 if not kernels else f"device busy {out['busy_ms']:.4f} ms/step (idle "
                 f"{1 - busy / wall_us:.1%})")
    print(f"    {label}: wall {out['wall_ms']:.4f} ms/step, {busy_note}, "
          f"{out['device_kernels']:.1f} kernels/step on the device; host launches/step: "
          f"{out['host_kernel_launches']:.2f} kernels, {out['host_graph_launches']:.4f} "
          f"graphs {tag}", flush=True)
    return out


def _timed_calls(fn, state, calls):
    """(state, ms of each call): CUDA events around each of `calls` calls of
    fn, the state carried from call to call."""
    import torch

    events = []
    for _ in range(calls):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        state = fn(state)[0]
        e.record()
        events.append((s, e))
    _sync()
    return state, [s.elapsed_time(e) for s, e in events]


# The last capture record and the pool bytes a note has reported.
_NOTED = {"id": -1, "pool_bytes": 0}


def _program_note() -> str:
    """The captures since the previous note, from the tracing registry's
    set-up records: each capture's ms (its warm-up call included) and the
    device memory their graphs keep."""
    from sbsim_tpu_torch.utils import profiling

    setup = profiling.setup()
    ms = [(r.end_ns - r.start_ns) / 1e6 for r in setup["records"]
          if r.name == "sbsim.graphs.capture" and r.id > _NOTED["id"]]
    if setup["records"]:
        _NOTED["id"] = setup["records"][-1].id
    pool = setup["counters"].get("graphs.pool_bytes", 0)
    pool, _NOTED["pool_bytes"] = pool - _NOTED["pool_bytes"], pool
    return (f"captures {', '.join(f'{t:.0f}' for t in ms) or 'none'} ms (warm-up calls "
            f"included), pool {pool / 2**20:.1f} MiB")


# The draw kernel's launches (rng.launch_counts) of one env step (the key
# split, two occupancy peeks), a seeding step, and a train step before and
# past the update gate (15: the collect step's 7, the update's 8).
SEED_DRAWS = {"split": 4, "uniform": 3}
TRAIN_DRAWS = {False: {"split": 6, "uniform": 3, "normal": 1},
               True: {"split": 8, "uniform": 3, "normal": 3, "randint": 1}}


def _rollout_draws(steps):
    return {"split": steps, "uniform": 2 * steps}


def graph_rollouts(tag) -> dict:
    """(a): the bench's make_rollout, one captured program per call shape,
    against the rollout op by op (`fn`): a replay from a clone of the eager
    run's start, under set_sync_debug_mode("error"), bitwise on every state
    field and the mean reward, with the eager run's launches; then the two
    paths timed (eager, graph, graph, eager) and profiled at the bench's
    call."""
    import torch
    from sbsim_tpu_torch import bench, convert, graphs, rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.envs import building_env

    dev = torch.device(DEVICE)
    clone = lambda tree: graphs.tree_map(torch.clone, tree)
    launches = dict.fromkeys(COUNTED, 0)
    for label, extra, solver, batch in BENCH_RUNS:
        t_start = time.time()
        name = label[4:]
        env = building_env.BuildingEnv(bench.bench_config("--full-scale" in extra), device=dev)
        table = schedule_policy.build_schedule_actions(env)
        states0, _ = env.reset(rng.split(rng.PRNGKey(0, device=dev), batch))
        kname = kernel_of(env, solver)
        rolls = {}
        for _, start, steps in BENCH_ROLLOUTS:
            first = states0.replace(step_idx=torch.full_like(states0.step_idx, start))
            roll = rolls[start, steps] = bench.make_rollout(env, table, steps, solver)
            what = f"phase 14 (a) {name} {solver} {steps} steps from step {start}"
            want, draws = {kname: steps}, _rollout_draws(steps)
            (eager, eager_r), counts = _counted(f"{what} eager", lambda: roll.eager(clone(first)),
                                                want, draws=draws)
            _add(launches, counts)
            _, counts = _counted(f"{what} first call", lambda: roll(clone(first)), want,
                                 draws=draws)
            _add(launches, counts)
            start_state = clone(first)
            (got, got_r), counts = _counted(f"{what} replay", lambda: roll(start_state), want,
                                            sync_free=True, draws=draws)
            _add(launches, counts)
            _check_equal_trees(what, convert.env_state_to_numpy(got),
                               convert.env_state_to_numpy(eager))
            (program,) = roll.programs.values()
            if not torch.equal(got_r, eager_r) or program.replays != 1:
                fail(f"{what}: mean reward {float(got_r)} replayed, {float(eager_r)} eager "
                     f"({program.replays} replays)")
            print(f"  (a) {name} {solver} B={batch}: {steps} steps from step {start}, the "
                  f"replay bitwise the eager rollout (states, mean reward "
                  f"{float(got_r):.6f}), {steps} {kname} launches and {3 * steps} draw "
                  f"launches per call on both paths, no host sync in the replay; "
                  f"{_program_note()} {tag}", flush=True)
        roll = bench.make_rollout(env, table, GRAPH_TIMED_STEPS, solver)
        ms = {"eager": [], "graph": []}
        for path in ("eager", "graph", "graph", "eager"):
            fn = roll.eager if path == "eager" else roll

            def run():
                state = fn(clone(states0))[0]  # untimed: the first call captures
                return _timed_calls(fn, state, GRAPH_TIMED_CALLS)

            (state, times), counts = _counted(
                f"phase 14 (a) {name} {path} timed calls", run,
                {kname: GRAPH_TIMED_STEPS * (1 + GRAPH_TIMED_CALLS)},
                draws=_rollout_draws(GRAPH_TIMED_STEPS * (1 + GRAPH_TIMED_CALLS)))
            _add(launches, counts)
            ms[path] += times
        per_step = {p: statistics.median(t) / GRAPH_TIMED_STEPS for p, t in ms.items()}
        best = {p: min(t) / GRAPH_TIMED_STEPS for p, t in ms.items()}
        print(f"  (a) {name} {solver} B={batch}, {GRAPH_TIMED_STEPS}-step calls, "
              f"{GRAPH_TIMED_CALLS} timed per run (eager, graph, graph, eager): eager median "
              f"{per_step['eager']:.4f} ms/step ({batch / per_step['eager'] * 1e3:,.0f} "
              f"env-steps/s, best {batch / best['eager'] * 1e3:,.0f}), graph median "
              f"{per_step['graph']:.4f} ms/step ({batch / per_step['graph'] * 1e3:,.0f} "
              f"env-steps/s, best {batch / best['graph'] * 1e3:,.0f}), "
              f"x{per_step['eager'] / per_step['graph']:.2f}; {_program_note()} {tag}",
              flush=True)
        # The profiles: one call of the first (8-step, captured) rollout.
        (start, steps), roll = next(iter(rolls.items()))
        first = states0.replace(step_idx=torch.full_like(states0.step_idx, start))
        for path, fn in (("eager", roll.eager), ("graph", roll)):
            _, counts = _counted(f"phase 14 (a) {name} {path} profile", lambda: _launch_profile(
                lambda: fn(first), steps, f"{name} {path} profile", tag), {kname: steps})
            _add(launches, counts)
        print(f"  (a) {name} {solver} in {time.time() - t_start:.1f} s", flush=True)
    return launches


def graph_training(tag) -> dict:
    """(b): the train12 recipe's seeding and train steps as captured
    programs against the steps op by op, call for call from cloned
    starting states: every TrainState field and every metric bitwise,
    the replays (all calls but each program's first) under
    set_sync_debug_mode("error") with the eager calls' launches; then
    both paths timed. (c): evaluate of a day, captured, against eager."""
    import torch
    from sbsim_tpu_torch import convert, graphs, rng
    from sbsim_tpu_torch.agents import schedule_policy, train
    from sbsim_tpu_torch.envs import building_env, presets

    dev = torch.device(DEVICE)
    clone = lambda tree: graphs.tree_map(torch.clone, tree)
    launches = dict.fromkeys(COUNTED, 0)
    t_start = time.time()
    env = building_env.BuildingEnv(presets.sb1_config(num_days_in_episode=1), device=dev)
    seed_steps = (GRAPH_SEED_CALLS + GRAPH_SKIP_CALLS + 1) * GRAPH_ENVS
    trainer = train.SACTrainer(env, train.recipe_for(
        env, n_envs=GRAPH_ENVS, batch_size=256, replay_capacity=50_000,
        updates_per_env_step=1, seed_steps=seed_steps))
    state0 = trainer.init(rng.PRNGKey(0, device=dev))
    state0 = state0.replace(env_states=state0.env_states.replace(
        step_idx=torch.full_like(state0.env_states.step_idx, GRAPH_SEED_START)))
    episode = env.steps_per_episode
    table = schedule_policy.build_schedule_actions(env)
    seed = trainer.seed_with_actions(state0, table)
    step = trainer.captured_train_step()
    plan = [("seed", seed, seed.eager)] * GRAPH_SEED_CALLS + [
        ("train", step, trainer.train_step)] * GRAPH_TRAIN_CALLS
    graph_state, eager_state = clone(state0), clone(state0)
    done_at, sides, replays = [], [], 0
    for i, (kind, graph_fn, eager_fn) in enumerate(plan):
        program = seed.program if kind == "seed" else step.sides[
            trainer.learns(graph_state.env_steps + GRAPH_ENVS)].program
        replay = bool(program.programs)
        what = f"phase 14 (b) {kind} call {i + 1}{' (replay)' if replay else ''}"
        want = {"fdm_jacobi": 1}
        draws = (SEED_DRAWS if kind == "seed" else
                 TRAIN_DRAWS[trainer.learns(graph_state.env_steps + GRAPH_ENVS)])
        (eager_state, eager_m), counts = _counted(f"{what} eager",
                                                  lambda: eager_fn(eager_state), want,
                                                  draws=draws)
        _add(launches, counts)
        (graph_state, graph_m), counts = _counted(what, lambda: graph_fn(graph_state), want,
                                                  sync_free=replay, draws=draws)
        _add(launches, counts)
        diff = _tree_diff(convert.train_state_to_numpy(graph_state, trainer),
                          convert.train_state_to_numpy(eager_state, trainer))
        diff += [(k, float("nan")) for k in eager_m
                 if not torch.equal(graph_m[k], eager_m[k])]
        if diff or graph_state.env_steps != eager_state.env_steps:
            fail(f"{what}: graph and eager differ in {diff}")
        replays += replay
        if kind == "train":
            sides.append(bool(graph_m["critic_loss"] != 0))
        if bool((graph_state.env_states.step_idx == 0).all()):
            done_at.append(i + 1)
    want_sides = [False] * GRAPH_SKIP_CALLS + [True] * (GRAPH_TRAIN_CALLS - GRAPH_SKIP_CALLS)
    crossing = episode - GRAPH_SEED_START
    if sides != want_sides or done_at != [crossing] or replays != len(plan) - 3:
        fail(f"phase 14 (b): learned {sides} (want {want_sides}), every env reset at calls "
             f"{done_at} (want [{crossing}]), {replays} replays")
    print(f"  (b) train12 (sb1 1-day, n_envs {GRAPH_ENVS}, batch 256, replay 50,000, "
          f"seed_steps {seed_steps}): {GRAPH_SEED_CALLS} seeding steps from step "
          f"{GRAPH_SEED_START} (every env reset at step {episode}, inside replay {crossing}), "
          f"then {GRAPH_TRAIN_CALLS} train steps ({GRAPH_SKIP_CALLS} before the gate, "
          f"{GRAPH_TRAIN_CALLS - GRAPH_SKIP_CALLS} after): each call's TrainState and metrics "
          f"bitwise the eager call's, {replays} replays with no host sync and 1 fdm_jacobi "
          f"launch each as eager, draw launches {sum(SEED_DRAWS.values())} per seeding step, "
          f"{sum(TRAIN_DRAWS[False].values())} / {sum(TRAIN_DRAWS[True].values())} per train "
          f"step before / past the gate; seeding and both sides: {_program_note()} {tag}",
          flush=True)
    # Both paths timed: seeding steps, then train steps past the gate.
    ms = {}
    for kind, fns in (("seed", (seed.eager, seed)),
                      ("train", (trainer.train_step, step))):
        for path, fn in zip(("eager", "graph"), fns):
            start = clone(graph_state)
            (_, times), counts = _counted(
                f"phase 14 (b) timed {kind} {path}",
                lambda: _timed_calls(fn, start, GRAPH_TRAIN_TIMED),
                {"fdm_jacobi": GRAPH_TRAIN_TIMED})
            _add(launches, counts)
            ms[kind, path] = statistics.median(times)
    for kind in ("seed", "train"):
        e, g = ms[kind, "eager"], ms[kind, "graph"]
        print(f"  (b) train12 {kind} step ({GRAPH_TRAIN_TIMED} calls each, CUDA events): "
              f"eager median {e:.3f} ms ({GRAPH_ENVS / e * 1e3:,.0f} env-steps/s), graph "
              f"median {g:.3f} ms ({GRAPH_ENVS / g * 1e3:,.0f} env-steps/s), x{e / g:.2f} "
              f"{tag}", flush=True)
    for path, fn in (("eager", trainer.train_step), ("graph", step)):
        start = clone(graph_state)
        _, counts = _counted(f"phase 14 (b) {path} profile", lambda: _launch_profile(
            lambda: fn(start), 1, f"train12 train step {path} profile", tag),
            {"fdm_jacobi": 1})
        _add(launches, counts)

    print(f"  (b) in {time.time() - t_start:.1f} s", flush=True)

    # ---- (c) evaluate of a day ---------------------------------------------
    t_start = time.time()
    n_steps, n_envs = GRAPH_EVAL
    evaluate = trainer.captured_evaluate()
    key = rng.PRNGKey(7, device=dev)
    sac = graph_state.sac
    want = {"fdm_jacobi": n_steps}
    runs = {}
    for label, fn, sync_free in (("eager", trainer.evaluate, False),
                                 ("first call", evaluate, False),
                                 ("replay", evaluate, True)):
        s, e = _events()
        s.record()
        ret, counts = _counted(f"phase 14 (c) evaluate {label}",
                               lambda: fn(sac, key, n_steps, n_envs), want, sync_free)
        e.record()
        _sync()
        _add(launches, counts)
        runs[label] = (ret, s.elapsed_time(e))
    if not torch.equal(runs["replay"][0], runs["eager"][0]):
        fail(f"phase 14 (c): evaluate replayed {float(runs['replay'][0])}, eager "
             f"{float(runs['eager'][0])}")
    print(f"  (c) evaluate, {n_steps} steps at {n_envs} envs: the replay's return "
          f"{float(runs['replay'][0]):.6f} bitwise the eager call's, {n_steps} launches each, "
          f"no host sync in the replay; eager {runs['eager'][1]:.1f} ms, replay "
          f"{runs['replay'][1]:.1f} ms; {_program_note()}; in "
          f"{time.time() - t_start:.1f} s {tag}", flush=True)
    return launches


# (d) the draws at the main paths' shapes: (label, draw, keys (None: one
# key), its arguments after the keys). The env step's key split and
# occupancy peeks at office12 B=2048 and office126 B=512, the trainer's
# three-way split at 64 envs, the actor's normals and the replay's indices
# at batch 256 (the bound a device int32, as the replay's size), the
# threefry word plane of two planes at office12 B=2048.
GRAPH_DRAWS = (
    ("split 2048 x 4", "split", 2048, (4,)),
    ("split 512 x 4", "split", 512, (4,)),
    ("split 64 x 3", "split", 64, (3,)),
    ("uniform 2048 x (12, 1)", "uniform", 2048, ((12, 1),)),
    ("uniform 512 x (126, 1)", "uniform", 512, ((126, 1),)),
    ("normal (256, 3)", "normal", None, ((256, 3),)),
    ("randint (256,)", "randint", None, ((256,), 0, "bound")),
    ("bits 2048 x (2, 52, 67)", "bits", 2048, ((2, 52, 67),)),
)
# Draws per timed graph (the word plane's, then the others'), replays timed.
GRAPH_DRAW_CALLS = (2, 40)
GRAPH_DRAW_REPS = 5
# The kernels line's row: one office12 env step's draws at B=2048.
DRAW_ROW = ("split 2048 x 4", "uniform 2048 x (12, 1)", "uniform 2048 x (12, 1)")
# One threefry2x32 block in int32 operations: the key schedule's 2 xors,
# 2 adds in, 20 rounds of an add, a funnel-shift rotate and an xor, and 5
# injections of 3 adds.
THREEFRY_OPS = 2 + 2 + 20 * 3 + 5 * 3


def draw_bound_ms(kind, n_keys, n_out, out_bytes, bw, flops):
    """Least time for one draw: its keys read and its output written once at
    the card's bandwidth, or its threefry2x32 blocks (a pair of words each
    for split, two per output and two per key for randint) at the card's
    int32 rate, 64 operations per SM per clock, a quarter of the float32
    FLOP/s of its fused multiply-adds; the larger of the two. The epilogues'
    float work is not counted, so the bound is a floor."""
    blocks = 2 * n_out + 2 * n_keys if kind == "randint" else n_out
    t_bytes = (16 * n_keys + out_bytes) / bw * 1e3
    t_ops = blocks * THREEFRY_OPS / (flops / 4) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _draw_graph_ms(fn, calls):
    """Device ms per call of fn: `calls` calls captured in one CUDA graph,
    the median of GRAPH_DRAW_REPS replays (CUDA events) over `calls`."""
    import torch
    from sbsim_tpu_torch import graphs

    graph = torch.cuda.CUDAGraph()
    with graphs._capture_open(), torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    ms = []
    for _ in range(GRAPH_DRAW_REPS):
        s, e = _events()
        s.record()
        graph.replay()
        e.record()
        _sync()
        ms.append(s.elapsed_time(e) / calls)
    graph.reset()
    return statistics.median(ms)


def graph_draws(bw, flops, tag) -> dict:
    """(d): each draw of GRAPH_DRAWS through the kernel (rng.<draw>) and its
    plain version (rng.<draw>_plain) on the same card keys, the keys
    strided views as the call sites pass them: bitwise equal, one kernel
    launch; both timed in CUDA graphs (_draw_graph_ms) beside
    draw_bound_ms. Returns the kernels line's draw row (DRAW_ROW)."""
    import torch
    from sbsim_tpu_torch import rng

    t_start = time.time()
    dev = torch.device(DEVICE)
    base = rng.PRNGKey(2_000_000_011, device=dev)
    bound = torch.tensor(50_000, dtype=torch.int32, device=dev)
    rows = {}
    for label, kind, n_keys, args in GRAPH_DRAWS:
        keys = base if n_keys is None else rng.split(rng.split(base, n_keys), 4)[:, 1]
        args = tuple(bound if a == "bound" else a for a in args)
        kernel = lambda: getattr(rng, kind)(keys, *args)
        plain = lambda: getattr(rng, f"{kind}_plain")(keys, *args)
        rng.reset_launch_counts()
        got, want = kernel(), plain()
        _sync()
        drawn = {k: n for k, n in rng.launch_counts.items() if n}
        if drawn != {kind: 1}:
            fail(f"phase 14 (d) {label}: draw launches {drawn}, want {{{kind!r}: 1}}")
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            fail(f"phase 14 (d) {label}: the kernel's {got.dtype} {tuple(got.shape)} differs "
                 f"from the plain version's {want.dtype} {tuple(want.shape)}")
        calls = GRAPH_DRAW_CALLS[0] if kind == "bits" else GRAPH_DRAW_CALLS[1]
        ms, plain_ms = _draw_graph_ms(kernel, calls), _draw_graph_ms(plain, calls)
        DRAWN["launches"] += 1 + calls * (1 + GRAPH_DRAW_REPS)
        n_out = got.numel() // (2 if kind == "split" else 1)
        b_ms, b_by = draw_bound_ms(kind, 1 if n_keys is None else n_keys, n_out,
                                   got.numel() * got.element_size(), bw, flops)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"  (d) {label}: the kernel bitwise its plain version on the same "
              f"keys, one launch; {ms * 1e3:.2f} us per draw, plain {plain_ms * 1e3:.1f} us "
              f"(a graph of {calls}, median of {GRAPH_DRAW_REPS} replays), bound "
              f"{b_ms * 1e3:.4f} us ({b_by}) {tag}", flush=True)
    row = {k: sum(rows[label][k] for label in DRAW_ROW) for k in ("ms", "plain_ms", "bound_ms")}
    row["bound_by"] = "/".join(sorted({rows[label]["bound_by"] for label in DRAW_ROW}))
    print(f"  (d) in {time.time() - t_start:.1f} s", flush=True)
    return row


def graph_phase(tag, bw, flops):
    """Phase 14; returns its launches and the kernels line's draw row."""
    t_start = time.time()
    launches = graph_rollouts(tag)
    _add(launches, graph_training(tag))
    row = graph_draws(bw, flops, tag)
    print(f"  phase 14 in {time.time() - t_start:.1f} s {tag}", flush=True)
    return launches, row


# ---------------------------------------------------------------------------
# Phase 15: the rest of the jitted programs as CUDA graphs
# ---------------------------------------------------------------------------

# (a) a one-rank NCCL group at the train12 recipe: REST_CALLS calls of each
# of mesh.py's steps (the train steps' update gate opening after REST_SKIP
# of them), then REST_TIMED timed calls per path; the rollout
# REST_ROLL_STEPS steps. (b) a day of HostEnvironment at each host config
# and of the dashboard; the 126-room parity day cut to REST_PARITY_STEPS.
REST_CALLS = 5
REST_SKIP = 2
REST_TIMED = 6
REST_ROLL_STEPS = 8
REST_DAY = 288
REST_PARITY_STEPS = 24


def _replays_equal(what, graph_fn, eager_fn, start, calls, captures, want, tree):
    """`calls` calls of the captured `graph_fn` and of `eager_fn` from clones
    of `start`, the state carried on each path: each call's state (as
    `tree` gives it) and metrics bitwise equal, with the launches `want`;
    the calls not in `captures` (0-based: those that capture) under
    set_sync_debug_mode("error"). Returns (the graph path's state, the
    launches)."""
    import torch
    from sbsim_tpu_torch import graphs

    clone = lambda t: graphs.tree_map(torch.clone, t)
    graph, eager = clone(start), clone(start)
    total = 0
    for i in range(calls):
        label = f"{what} call {i + 1}"
        (eager, em), counts = _counted(f"{label} eager", lambda: eager_fn(eager), want)
        total += sum(counts.values())
        (graph, gm), counts = _counted(label, lambda: graph_fn(graph), want,
                                       sync_free=i not in captures)
        total += sum(counts.values())
        diff = _tree_diff(tree(graph), tree(eager))
        if isinstance(em, dict):
            diff += [(k, float("nan")) for k in em if not torch.equal(gm[k], em[k])]
        elif not torch.equal(gm, em):
            diff.append(("output", float("nan")))
        if diff or getattr(graph, "env_steps", 0) != getattr(eager, "env_steps", 0):
            fail(f"{label}: graph and eager differ in {diff}")
    return graph, total


def _eager_graph_ms(graph_fn, eager_fn, start, calls):
    """Median ms per call of each path (CUDA events), `calls` calls from a
    clone of `start`, eager then graph; and the launches."""
    import torch
    from sbsim_tpu_torch import graphs
    from sbsim_tpu_torch.physics import fdm_cuda

    ms = {}
    _sync()
    fdm_cuda.reset_launch_counts()
    for path, fn in (("eager", eager_fn), ("graph", graph_fn)):
        _, times = _timed_calls(fn, graphs.tree_map(torch.clone, start), calls)
        ms[path] = statistics.median(times)
    _sync()
    return ms, sum(fdm_cuda.launch_counts.values())


def _rank_graphs(rank, mesh, device, out) -> dict:
    """(a) on one rank of an NCCL group: distributed/mesh.py's four steps as
    captured programs against their eager calls (`eager`), call for call
    from clones of one start: state and metrics bitwise, the replays
    without a host sync, 1 K2 launch per env step on each path; then both
    paths timed and profiled."""
    import torch
    from sbsim_tpu_torch import convert, graphs, rng
    from sbsim_tpu_torch.agents import schedule_policy, train
    from sbsim_tpu_torch.distributed import mesh as mesh_lib
    from sbsim_tpu_torch.distributed import runtime

    if not runtime.captures(mesh.group) or torch.distributed.get_backend() != "nccl":
        fail("(a) the mesh's group is not an NCCL group whose steps are captured")
    env = make_env("12zone", device)
    trainer = train.SACTrainer(env, train.recipe_for(
        env, n_envs=DIST_ENVS, batch_size=256, replay_capacity=50_000,
        updates_per_env_step=1, seed_steps=(REST_CALLS + REST_SKIP + 1) * DIST_ENVS))
    table = schedule_policy.build_schedule_actions(env)
    state = mesh_lib.shard_train_state(trainer.init(rng.PRNGKey(3, device=device)), mesh)
    tree = lambda st: convert.train_state_to_numpy(st, trainer)
    res = {"launches": 0, "ms": {}, "profile": {}}
    steps = (("collect", mesh_lib.make_distributed_collect_step(trainer, mesh, table), (0,)),
             ("distributed train", mesh_lib.make_distributed_train_step(trainer, mesh),
              (0, REST_SKIP)),
             ("shardmapped train", mesh_lib.make_shardmapped_train_step(trainer, mesh, state),
              (0, REST_SKIP)))
    for name, step, captures in steps:
        start = state
        end, n = _replays_equal(f"phase 15 (a) {name}", step, step.eager, start, REST_CALLS,
                                captures, {"fdm_jacobi": 1}, tree)
        res["launches"] += n
        if name == "collect":  # the train steps start from the seeded ring
            state = graphs.tree_map(torch.clone, end)
        res["ms"][name], n = _eager_graph_ms(step, step.eager, end, REST_TIMED)
        res["launches"] += n
        for path, fn in (("eager", step.eager), ("graph", step)):
            first = graphs.tree_map(torch.clone, end)
            res["profile"][f"{name} {path}"], counts = _counted(
                f"phase 15 (a) {name} {path} profile",
                lambda: _launch_profile(lambda: fn(first), 1, f"{name} {path} profile", ""),
                {"fdm_jacobi": 1})
            res["launches"] += sum(counts.values())
    roll = mesh_lib.make_shardmapped_rollout(env, mesh, table, REST_ROLL_STEPS)
    states, _ = env.reset(rng.split(rng.PRNGKey(5, device=device), DIST_ENVS))
    # Each call from the same start: the rollout's state is its EnvState.
    restart = lambda fn: lambda _: fn(graphs.tree_map(torch.clone, states))
    _, n = _replays_equal("phase 15 (a) rollout", restart(roll), restart(roll.eager), states, 3,
                          (0,), {"fdm_jacobi": REST_ROLL_STEPS}, convert.env_state_to_numpy)
    res["launches"] += n
    ms, n = _eager_graph_ms(roll, roll.eager, states, REST_TIMED)
    res["ms"]["rollout"] = {k: v / REST_ROLL_STEPS for k, v in ms.items()}
    res["launches"] += n
    return res


def rest_distributed(tag) -> int:
    """(a): a one-rank NCCL group (`_rank_graphs`, run by phase 10 (c)'s rank
    when phase 10 ran); returns its launches."""
    import tempfile

    t_start = time.time()
    res, where = NCCL_GRAPHS, "in phase 10 (c)'s rank"
    if not res:
        with tempfile.TemporaryDirectory() as tmp:
            (res,) = _run_ranks("graphs", 1, "nccl", None, f"{tmp}/graphs")
        where = f"in {time.time() - t_start:.1f} s with start-up"
    for name, ms in res["ms"].items():
        per = "per env step" if name == "rollout" else "per call"
        prof = {p: res["profile"].get(f"{name} {p}") for p in ("eager", "graph")}
        kernels = "" if prof["eager"] is None else (
            f"; device kernels per call eager {prof['eager']['device_kernels']:.0f}, graph "
            f"{prof['graph']['device_kernels']:.0f}, host launch calls eager "
            f"{prof['eager']['host_kernel_launches']:.0f}, graph "
            f"{prof['graph']['host_kernel_launches']:.0f}")
        print(f"  (a) one-rank NCCL group, train12 (n_envs {DIST_ENVS}, batch 256): {name}: the "
              f"captured program bitwise its eager call on every call (replays without a host "
              f"sync); eager {ms['eager']:.3f} ms, graph {ms['graph']:.3f} ms {per} "
              f"(x{ms['eager'] / ms['graph']:.2f}, median of {REST_TIMED}, CUDA events)"
              f"{kernels} {tag}", flush=True)
    print(f"  (a) run {where}; K2 launches {res['launches']}", flush=True)
    return res["launches"]


def _same_host_runs(label, got, want) -> None:
    import numpy as np

    for i, (a, b) in enumerate(zip(got["steps"], want["steps"], strict=True)):
        if (a.step_type, a.discount) != (b.step_type, b.discount) or not np.array_equal(
                [a.reward], [b.reward]) or not np.array_equal(a.observation, b.observation):
            fail(f"{label}: time step {i} differs from the eager run")
    if not _same_metrics(got["metrics"], want["metrics"]) or got["files"] != want["files"] or [
            m for _, m in got["written"]] != [m for _, m in want["written"]]:
        fail(f"{label}: the metrics, record files or protos written differ from the eager run")


def rest_host(envs, tag) -> dict:
    """(b): a day of HostEnvironment through the captured per-env step at
    host12 (K2), chebyshev12 (K1) and host126 (K2), protos and record files
    byte-equal to the day op by op; the dashboard's day; the parity day's
    first REST_PARITY_STEPS steps. Returns the launches."""
    import tempfile

    import numpy as np
    import torch
    from sbsim_tpu_torch import convert, graphs
    from sbsim_tpu_torch.benchmarks import fullscale_parity_check as fpc
    from sbsim_tpu_torch.envs import building_env, presets

    dev = torch.device(DEVICE)
    launches = dict.fromkeys(COUNTED, 0)
    cfg = presets.sb1_config(num_days_in_episode=1)
    env12 = building_env.BuildingEnv(cfg, device=dev)
    runs = (("host12", env12, "fdm_jacobi"),
            ("chebyshev12", building_env.BuildingEnv(
                dataclasses.replace(cfg, fdm_solver="chebyshev"), device=dev), "fdm_cheby"),
            ("host126", envs["126room"], "fdm_jacobi"))
    with tempfile.TemporaryDirectory() as tmp:
        for label, env, kname in runs:
            t_start = time.time()
            policy = host_policy(env, 11, os.path.join(tmp, label))
            graph = host_run(env, policy, REST_DAY, plain=False, read_back=False)
            eager = host_run(env, policy, REST_DAY, plain=False, eager=True, read_back=False)
            want = {k: (REST_DAY if k == kname else 0) for k in COUNTED}
            if graph["counts"] != want or eager["counts"] != want:
                fail(f"{label}: launch counts {graph['counts']}, eager {eager['counts']}")
            _same_host_runs(label, graph, eager)
            launches[kname] += 2 * REST_DAY
            med = {}
            for path, run in (("eager", eager), ("graph", graph)):
                med[path] = [statistics.median(s.elapsed_time(e) for s, e in run[k][2:])
                             for k in ("step_events", "wait_events")]
            print(f"  (b) {label}: {REST_DAY} HostEnvironment steps through the captured "
                  f"per-env step ({kname}), time steps, metrics, {len(graph['written'])} protos "
                  f"and {len(graph['files'])} record files byte-equal to the day op by op; "
                  f"HostEnvironment.step median eager {med['eager'][0]:.3f} ms, graph "
                  f"{med['graph'][0]:.3f} ms; wait_time eager {med['eager'][1]:.3f} ms, graph "
                  f"{med['graph'][1]:.3f} ms (x{med['eager'][1] / med['graph'][1]:.2f}); "
                  f"{_program_note()}; in {time.time() - t_start:.1f} s {tag}",
                  flush=True)
        # The dashboard's day.
        t_start = time.time()
        days = {}
        for path in ("graph", "eager"):
            times = []
            run, counts = _dashboard(REST_DAY, os.path.join(tmp, f"dash_{path}"), False, [],
                                     times, eager=path == "eager")
            if counts != {k: (REST_DAY if k == "fdm_jacobi" else 0) for k in COUNTED}:
                fail(f"dashboard {path}: launch counts {counts}")
            days[path] = (run.dashboard, statistics.median(np.diff(times)[2:]) * 1e3)
        launches["fdm_jacobi"] += 2 * REST_DAY
        got, want = days["graph"][0], days["eager"][0]
        if not (np.array_equal(np.stack(got.zone_temps), np.stack(want.zone_temps))
                and got.energy_rates == want.energy_rates and got.timestamps == want.timestamps):
            fail("dashboard: the captured day differs from the day op by op")
        print(f"  (b) dashboard: {REST_DAY} steps of episode_dashboard.main through the captured "
              f"per-env step, zone temperatures, energy rates and timestamps bitwise the day op "
              f"by op; median {days['eager'][1]:.3f} ms per step eager, {days['graph'][1]:.3f} "
              f"ms graph (host clock, the dashboard's per-step read included); in "
              f"{time.time() - t_start:.1f} s {tag}", flush=True)
        # The parity day, cut.
        t_start = time.time()
        env = building_env.BuildingEnv(fpc.parity_config("auto"), device=dev)
        days = {}
        for path in ("graph", "eager"):
            t0 = time.time()
            with graphs.disabled() if path == "eager" else contextlib.nullcontext():
                day, counts = _counted(f"parity day {path}", lambda: fpc.parity_day(
                    env, REST_PARITY_STEPS, log=lambda m: None),
                    {"fdm_jacobi": REST_PARITY_STEPS})
            days[path] = (day, time.time() - t0)
        launches["fdm_jacobi"] += 2 * REST_PARITY_STEPS
        got, want = days["graph"][0], days["eager"][0]
        diff = _tree_diff(convert.env_state_to_numpy(got.state),
                          convert.env_state_to_numpy(want.state))
        if diff or got.drifts != want.drifts or got.modes_equal != want.modes_equal:
            fail(f"parity day: the captured day differs from the day op by op: {diff}")
        print(f"  (b) parity126: fullscale_parity_check.parity_day, its first {REST_PARITY_STEPS} "
              f"steps through the captured per-env step (K2, 126 rooms transposed) bitwise the "
              f"steps op by op (state, drifts, modes; largest drift {max(got.drifts):.6e} K); "
              f"{days['eager'][1]:.1f} s eager, {days['graph'][1]:.1f} s graph with the exact "
              f"host beside them; in {time.time() - t_start:.1f} s {tag}", flush=True)
    return launches


def rest_policy(tag) -> int:
    """(c): the loaded policy, captured, against the eager actor on the
    observations of a day of the 12-zone env (stepped by its captured
    per-env step at the zero action); returns the launches."""
    import tempfile

    import torch
    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.agents import policies, sac
    from sbsim_tpu_torch.envs import building_env, presets

    dev = torch.device(DEVICE)
    env = building_env.BuildingEnv(presets.sb1_config(num_days_in_episode=1), device=dev)
    action = torch.zeros((1, env.n_actions), device=dev)

    def day():
        state, _ = env.reset(rng.PRNGKey(4, device=dev)[None])
        obs = []
        for _ in range(REST_DAY):
            state, out = env.captured_step(state, action)
            obs.append(out.observation)
        return obs

    obs, _ = _counted("phase 15 (c) the day's observations", day, {"fdm_jacobi": REST_DAY})
    learner = sac.SACLearner(env.obs_dim, env.n_actions, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        policies.save_policy(tmp, learner, learner.init(rng.PRNGKey(13, device=dev)),
                             env.action_names)
        policy, _ = policies.load_policy(tmp, device=dev)
    events = {"eager": [], "graph": []}
    for i, o in enumerate(obs):
        out = {}
        for path, fn in (("eager", policy.program.eager), ("graph", policy)):
            s, e = _events()
            with _no_host_sync() if path == "graph" and i else contextlib.nullcontext():
                s.record()
                out[path] = fn(o)
                e.record()
            events[path].append((s, e))
        if not torch.equal(out["graph"], out["eager"]):
            fail(f"policy: the captured policy differs from the eager actor at step {i}")
    _sync()
    ms = {p: statistics.median(s.elapsed_time(e) for s, e in t[1:]) for p, t in events.items()}
    print(f"  (c) policy: load_policy's captured greedy forward bitwise the eager actor on the "
          f"{len(obs)} observations of a 12-zone day ({len(obs) - 1} replays without a host "
          f"sync); median {ms['eager']:.4f} ms eager, {ms['graph']:.4f} ms graph per action "
          f"(CUDA events) {tag}", flush=True)
    return REST_DAY


def rest_scripts(tmp, tag) -> int:
    """(d): sac_sb1_train.main on phase 11 (a)'s cut recipe op by op, its
    result equal to the captured run's (phase 11 (a)'s, run here when
    phase 11 did not run); run_swap's step program (its first call and
    replays) against the step op by op, and run_swap against its run op by
    op. Returns the launches."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import convert, graphs, rng
    from sbsim_tpu_torch.benchmarks import conv_rounds_sweep as crs
    from sbsim_tpu_torch.benchmarks import sac_sb1_train
    from sbsim_tpu_torch.envs import building_env

    launches = 0
    if not CURVE_RUN:
        launches += script_curve(tmp, tag)["fdm_jacobi"]
    graph = CURVE_RUN["result"]
    t0 = time.time()
    with graphs.disabled():
        eager, counts = _counted("phase 15 (d) curve12 op by op", lambda: sac_sb1_train.main(
            CURVE_ARGS + ["--out", os.path.join(tmp, "curve_eager.json")]),
            {"fdm_jacobi": _curve_launches(REST_DAY)})
    eager_s = time.time() - t0
    launches += counts["fdm_jacobi"]
    same = {k: v for k, v in graph.items() if k != "wall_sec"} == {
        k: v for k, v in eager.items() if k != "wall_sec"}
    if not same:
        fail(f"(d) curve12: the captured run's result {graph} differs from the run op by op "
             f"{eager}")
    print(f"  (d) curve12: sac_sb1_train.main {' '.join(CURVE_ARGS)} op by op: its result "
          f"(every return, the curve, every key but wall_sec) equal to the captured run's; "
          f"{eager_s:.1f} s op by op, {CURVE_RUN['seconds']:.1f} s captured (host clock, whole "
          f"run with set-up and captures) {tag}", flush=True)
    # run_swap's step program, replayed once per step.
    dev = torch.device(DEVICE)
    cfg = crs.base_config()
    env = building_env.BuildingEnv(cfg, device=dev)
    action = torch.as_tensor(env.default_action(crs.SETPOINTS), device=dev)
    action = action[None].expand(crs.SEEDS, -1).contiguous()
    states, _ = env.reset(rng.split(rng.PRNGKey(crs.SWAP_KEY, device=dev), crs.SEEDS))
    step = crs.swap_step(env)
    on = lambda fn: lambda st: (fn(st, action), torch.zeros(()))
    tree = lambda st: convert.env_state_to_numpy(st)
    _, n = _replays_equal("phase 15 (d) swap step", on(step), on(step.eager), states,
                          crs.N_STEPS, (0,), {"fdm_jacobi": 1}, tree)
    launches += n
    ms, n = _eager_graph_ms(on(step), on(step.eager), states, REST_TIMED)
    launches += n
    seconds = {}
    for path in ("graph", "eager"):
        _sync()
        t0 = time.perf_counter()
        with graphs.disabled() if path == "eager" else contextlib.nullcontext():
            (seconds[path + "_out"], _), counts = _counted(
                f"phase 15 (d) run_swap {path}", lambda: crs.run_swap(cfg, dev),
                {"fdm_jacobi": crs.N_STEPS})
        seconds[path] = (time.perf_counter() - t0) * 1e3
    launches += 2 * crs.N_STEPS
    if not np.array_equal(seconds["graph_out"], seconds["eager_out"]):
        fail("(d) run_swap through its captured step differs from its run op by op")
    print(f"  (d) run_swap (12 zones, {crs.SEEDS} envs, {crs.N_STEPS} steps through K2): its "
          f"step one captured program, its first call and {crs.N_STEPS - 1} replays bitwise the "
          f"steps op by op (the replays without a host sync), run_swap bitwise its run op by op; per step eager "
          f"{ms['eager']:.3f} ms, graph {ms['graph']:.3f} ms (x{ms['eager'] / ms['graph']:.2f}, "
          f"median of {REST_TIMED}, CUDA events); a whole run_swap call (a new env, its "
          f"capture included; host clock) {seconds['graph']:.1f} ms captured, "
          f"{seconds['eager']:.1f} ms op by op; {_program_note()} {tag}", flush=True)
    return launches


def rest_phase(envs, tag) -> dict:
    """Phase 15; returns its launches."""
    import tempfile

    t_start = time.time()
    launches = rest_host(envs, tag)
    launches["fdm_jacobi"] += rest_distributed(tag)
    launches["fdm_jacobi"] += rest_policy(tag)
    with tempfile.TemporaryDirectory() as tmp:
        launches["fdm_jacobi"] += rest_scripts(tmp, tag)
    print(f"  phase 15 in {time.time() - t_start:.1f} s {tag}", flush=True)
    return launches


# `chip_smoke.py --learn`: tests/test_sac_learning.py's two-zone recipe.
LEARN_STEPS = 3000
LEARN_SEED_STEPS = 100
LEARN_EVAL_EVERY = 1000


def learn_phase(train_steps, out, tag) -> None:
    """The learning runs on the card: tests/test_sac_learning.py:18-53's
    two-zone recipe with its three asserts, then the 12-zone sac_sb1_train
    curve to `train_steps` with --parity-eval, written to `out`."""
    import numpy as np
    import torch
    from sbsim_tpu_torch import rng
    from sbsim_tpu_torch.agents import schedule_policy
    from sbsim_tpu_torch.agents.train import SACTrainer, TrainConfig
    from sbsim_tpu_torch.benchmarks import sac_sb1_train
    from sbsim_tpu_torch.envs import building_env, presets

    env = building_env.BuildingEnv(presets.two_zone_test_config(num_days_in_episode=1),
                                   device=torch.device(DEVICE))
    trainer = SACTrainer(env, TrainConfig(n_envs=8, replay_capacity=20_000, batch_size=128,
                                          updates_per_env_step=2, seed_steps=0))
    state = trainer.init(rng.PRNGKey(0))
    seed = trainer.seed_with_actions(state, schedule_policy.build_schedule_actions(env))
    t0 = time.time()
    for _ in range(LEARN_SEED_STEPS):
        state, _ = seed(state)
    returns = []
    for i in range(LEARN_STEPS):
        state, metrics = trainer.train_step(state)
        if (i + 1) % LEARN_EVAL_EVERY == 0:
            returns.append(float(trainer.evaluate(state.sac, rng.PRNGKey(7), n_steps=48,
                                                  n_envs=2)))
            print(f"  learn2 step {i + 1}: eval {returns[-1]:.4f} critic "
                  f"{float(metrics['critic_loss']):.4f} alpha {float(metrics['alpha']):.4f} "
                  f"({time.time() - t0:.0f} s)", flush=True)
    critic, alpha = float(metrics["critic_loss"]), float(metrics["alpha"])
    ok = (np.isfinite(returns).all() and returns[-1] > returns[0] - 0.05 and critic < 1.0
          and alpha < 0.9)
    print(f"  learn2 (tests/test_sac_learning.py's recipe, two zones, n_envs 8, batch 128, 2 "
          f"updates per step, {LEARN_SEED_STEPS} seeding + {LEARN_STEPS} train steps through "
          f"K2 in {time.time() - t0:.1f} s): returns {returns}, critic loss {critic:.4f} "
          f"(< 1.0), alpha {alpha:.4f} (< 0.9), last >= first - 0.05: "
          f"{'passed' if ok else 'FAILED'} {tag}", flush=True)
    t0 = time.time()
    result = sac_sb1_train.main(["--train-steps", str(train_steps), "--parity-eval",
                                 "--out", out])
    print(f"  curve12 to {train_steps} train steps in {time.time() - t0:.1f} s: schedule "
          f"{result['schedule_baseline_return']}, untrained {result['untrained_return']}, best "
          f"{result['best_return']}, held out {result['best_return_holdout_seed']} against "
          f"{result['schedule_return_holdout_seed']}, beats_schedule {result['beats_schedule']}; "
          f"wrote {out} {tag}", flush=True)
    if not ok:
        fail("learn2: tests/test_sac_learning.py's asserts")


def repeat_phases(envs, seconds, bw, flops, tag) -> int:
    """Phases 5, 6 and 7, round after round until `seconds` have passed; a
    failed part is counted and the round goes on. Prints the rounds, the
    failed parts and the device_ms profiler windows that recorded no FDM
    kernel; returns 1 if any part failed."""
    t_start, rounds, failed = time.time(), 0, []
    while rounds == 0 or time.time() - t_start < seconds:
        rounds += 1
        max_err = dict.fromkeys(KERNELS, 0.0)
        parts = [(f"training {k}", lambda w=w, k=k, n=n, s=s, t=t, e=e: training_phase(
                     envs[w], k, n, s, t, e, max_err, bw, flops, tag))
                 for w, k, n, s, t, e in TRAINING]
        parts += [("train_sac", lambda: entry_train_sac(tag)),
                  ("suite", lambda: entry_suite(max_err, bw, flops, tag)),
                  ("windows", lambda: entry_windows(tag)),
                  ("host", lambda: host_phase(envs, tag))]
        for name, fn in parts:
            try:
                fn()
            except SystemExit:
                failed.append((rounds, name))
        print(f"repeat: round {rounds} done at {time.time() - t_start:.1f} s", flush=True)
    print(f"repeat: {rounds} rounds of phases 5-7 in {time.time() - t_start:.1f} s; failed "
          f"parts {failed}; profiler windows {profile_windows['opened']}, "
          f"{profile_windows['empty']} of them with no FDM kernel {tag}", flush=True)
    return 1 if failed else 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; nothing was run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "sbsim_tpu_torch")):
        print("chip_smoke: sbsim_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # Full float32 matrix products (no TF32) in the SAC networks.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from sbsim_tpu_torch import buildcache
    from sbsim_tpu_torch.physics import fdm_cuda

    t_start = time.time()
    # ---- Phase 0 ---------------------------------------------------------
    card = card_line()
    name = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    nvcc = subprocess.run([buildcache.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda}; nvcc: {nvcc}; "
          f"card: {card}; devices: {torch.cuda.device_count()}", flush=True)
    peak_key, (bw, flops) = peaks(name)
    print(f"  bound uses the H100 {peak_key} peaks: {bw / 1e12} TB/s, "
          f"{flops / 1e12} TFLOP/s float32", flush=True)
    dev = torch.device(DEVICE)

    # ---- Phase 1 ---------------------------------------------------------
    t0 = time.time()
    path = fdm_cuda.build()
    fdm_cuda._library()
    print(f"phase 1: built {os.path.relpath(path, REPO)} in {time.time() - t0:.1f} s", flush=True)
    for line in fdm_cuda.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    envs = {which: make_env(which, dev) for which in _PLANS}
    if "--decomposition" in sys.argv:
        # Only the kernels' decomposition, with their SASS written into the
        # directory that follows the flag, if one does; `--envs 1,2,4,8`
        # names K3's block widths (an older package's K3 takes up to 8);
        # `--e3` adds the E=3 repeats.
        rest = sys.argv[sys.argv.index("--decomposition") + 1:]
        es = None
        if "--envs" in rest:
            i = rest.index("--envs")
            es = tuple(int(v) for v in rest[i + 1].split(","))
            rest = rest[:i] + rest[i + 2:]
        e3 = "--e3" in rest
        rest = [a for a in rest if a != "--e3"]
        decomposition(envs, tag, sass_dir=rest[0] if rest else None, jacobi_envs=es)
        if e3:
            e3_repeats(envs, tag)
        return 0
    if "--repeat" in sys.argv:
        seconds = float(sys.argv[sys.argv.index("--repeat") + 1])
        return repeat_phases(envs, seconds, bw, flops, tag)
    if "--ranks" in sys.argv:
        # Only phase 10 at `--ranks N` ranks in (a) over `--backend` (nccl:
        # one rank per card), phase 11 (b), the scaling harness at 1, 2,
        # ..., N ranks, and phase 12 (e), the decomposition at N ranks.
        n = int(sys.argv[sys.argv.index("--ranks") + 1])
        backend = sys.argv[sys.argv.index("--backend") + 1] if "--backend" in sys.argv else "gloo"
        if backend == "nccl" and n > torch.cuda.device_count():
            fail(f"{n} NCCL ranks need {n} cards; {torch.cuda.device_count()} present")
        print(f"phase 10: the distributed path at {n} ranks over {backend}", flush=True)
        distributed_phase(envs, tag, ranks=n, backend=backend, with_graphs=False)
        counts = [1 << i for i in range(n.bit_length()) if 1 << i < n] + [n]
        print(f"phase 11: the scaling harness at {counts} ranks over {backend}", flush=True)
        scripts_phase(tag, rank_counts=counts, backend=backend, only="b")
        print(f"phase 12: the scaling decomposition at {n} ranks over {backend}", flush=True)
        study_phase(tag, ranks=n, backend=backend, only="e")
        return 0
    if "--graphs" in sys.argv:
        # `--graphs [14|15]`: phases 14 and 15, or the one named.
        rest = sys.argv[sys.argv.index("--graphs") + 1:]
        only = rest[0] if rest and rest[0] in ("14", "15") else None
        if only != "15":
            print("phase 14: the jitted programs as CUDA graphs", flush=True)
            graph_phase(tag, bw, flops)
        if only != "14":
            print("phase 15: the rest of the jitted programs as CUDA graphs", flush=True)
            rest_phase(envs, tag)
        return 0
    if "--cluster" in sys.argv:
        cluster_phase(dict.fromkeys(COUNTED, 0.0), bw, flops, tag)
        return 0
    if "--learn" in sys.argv:
        # Only the learning runs: `--learn [TRAIN_STEPS] [--out PATH]`.
        rest = sys.argv[sys.argv.index("--learn") + 1:]
        steps = int(rest[0]) if rest and rest[0].isdigit() else 12_000
        out = (rest[rest.index("--out") + 1] if "--out" in rest
               else os.path.join(REPO, "artifacts", "sac_sb1_12zone_torch_curve.json"))
        print(f"learn: the two-zone recipe, then the 12-zone curve to {steps} train steps",
              flush=True)
        learn_phase(steps, out, tag)
        return 0
    max_err = dict.fromkeys(COUNTED, 0.0)
    check_phase(envs, max_err)
    launches, timing = main_path_phase(envs, max_err, bw, flops, tag)
    counts, cluster_rows = cluster_phase(max_err, bw, flops, tag)
    _add(launches, counts)
    decomposition(envs, tag)
    wiring_phase(envs)

    # ---- Phase 5 ---------------------------------------------------------
    print("phase 5: SAC training at full width", flush=True)
    for which, kname, n_envs, seed_steps, train_steps, eval_steps in TRAINING:
        launches[kname] += training_phase(envs[which], kname, n_envs, seed_steps,
                                          train_steps, eval_steps, max_err, bw, flops, tag)

    # ---- Phase 6 ---------------------------------------------------------
    print("phase 6: entry points at full width", flush=True)
    launches["fdm_jacobi"] += entry_train_sac(tag)
    launches["fdm_jacobi"] += entry_suite(max_err, bw, flops, tag)
    entry_windows(tag)

    # ---- Phase 7 ---------------------------------------------------------
    print("phase 7: the proto host path", flush=True)
    for kname, n in host_phase(envs, tag).items():
        launches[kname] += n

    # ---- Phase 8 ---------------------------------------------------------
    print("phase 8: the offline-learning path", flush=True)
    for kname, n in offline_phase(tag).items():
        launches[kname] += n

    # ---- Phase 9 ---------------------------------------------------------
    print("phase 9: the validation path", flush=True)
    for kname, n in validation_phase(tag).items():
        launches[kname] += n

    # ---- Phase 10 --------------------------------------------------------
    print("phase 10: the distributed path", flush=True)
    for kname, n in distributed_phase(envs, tag).items():
        launches[kname] += n

    # ---- Phase 11 --------------------------------------------------------
    print("phase 11: the scripts", flush=True)
    for kname, n in scripts_phase(tag).items():
        launches[kname] += n

    # ---- Phase 12 --------------------------------------------------------
    print("phase 12: the study scripts", flush=True)
    for kname, n in study_phase(tag).items():
        launches[kname] += n

    # ---- Phase 13 --------------------------------------------------------
    print("phase 13: the port bench", flush=True)
    for kname, n in bench_phase(card, tag).items():
        launches[kname] += n

    # ---- Phase 14 --------------------------------------------------------
    print("phase 14: the jitted programs as CUDA graphs", flush=True)
    counts, draw_row = graph_phase(tag, bw, flops)
    _add(launches, counts)

    # ---- Phase 15 --------------------------------------------------------
    print("phase 15: the rest of the jitted programs as CUDA graphs", flush=True)
    _add(launches, rest_phase(envs, tag))

    # ---- Phase 16 --------------------------------------------------------
    rows = {"fdm_cheby": "12zone", "fdm_jacobi": "12zone",
            "fdm_cheby_block": "12zone stack", "fdm_jacobi_block": "12zone stack"}
    kernels = []
    for kname in KERNELS:
        t = timing[(kname, rows[kname])]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "sbsim_tpu_torch/csrc/fdm_kernels.cu",
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max_err[kname], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "shape": f"{rows[kname]} B={t['batch']}",
        })
    for body, t in cluster_rows.items():  # K1-K4's semantics: no Pallas body of their own
        kernels.append({
            "name": body, "route": "cuda", "source": "sbsim_tpu_torch/csrc/fdm_kernels.cu",
            "replaces": None, "launches": launches[body], "max_abs_err": max_err[body],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": f"{CLUSTER_RUN[0]} B={t['batch']}",
        })
    kernels.append({
        "name": "rng_draw", "route": "cuda", "source": "sbsim_tpu_torch/csrc/rng_kernels.cu",
        "replaces": None, "launches": DRAWN["launches"], "max_abs_err": 0.0,
        "ms": draw_row["ms"], "plain_ms": draw_row["plain_ms"],
        "bound_ms": draw_row["bound_ms"], "bound_by": draw_row["bound_by"],
        "library_ms": None, "shape": "12zone B=2048, one env step's draws: " + ", ".join(DRAW_ROW),
    })
    for (kname, label), t in sorted(timing.items()):
        print(f"{kname} at {label} B={t['batch']}: {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) {tag}")
    print(f"all phases in {time.time() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
