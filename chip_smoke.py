#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sbsim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # all phases
    python3 chip_smoke.py --decomposition [DIR] [--envs 1,2,4,8] [--e3]
        # phases 0-1 and the kernels' decomposition; SASS into DIR; K3 at
        # the given block widths; K3/K4 at E=3 six times each
    python3 chip_smoke.py --repeat SECONDS
        # phases 0-1, then phases 5-7 round after round for SECONDS,
        # counting failed parts and empty profiler windows

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
     kernels by device time). Then the decomposition of K1/K4 and K2/K3 at
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
     schedule-table seeding steps, 32 train_steps, evaluate(n_steps=8,
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
     schedule-table seeding steps (every env's `done` at step 288, reset
     by _maybe_reset bitwise as env.reset on the same keys, step_idx 2
     after step 290), 8 train_steps with an evaluation of 16 steps and a
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
  8. A {"kernels": [...]} line, then the last line
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
    ("12zone", "12zone", 2048, "pallas_cheby", 32),
    ("126room", "126room", 512, "pallas_cheby", 32),
    ("12zone", "12zone", 2048, "pallas_env", 8),
    ("12zone stack", "12zone_stack", 2048, "pallas_cheby", 32),
    ("12zone stack", "12zone_stack", 2048, "pallas_env", 8),
    ("126room stack", "126room_stack", 512, "pallas_cheby", 32),
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


def make_env(which: str, device):
    from sbsim_tpu_torch.core import geometry
    from sbsim_tpu_torch.envs import building_env, presets

    spec = _PLANS[which]
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


def block_envs(env, kname: str) -> int:
    """The envs per thread block K3 or K4 (kname) runs for this env's
    config."""
    from sbsim_tpu_torch.physics import fdm_cuda

    return fdm_cuda.effective_block_envs(env.geom.shape, env.config.pallas_block_envs,
                                         cheby=kname.startswith("fdm_cheby"))


def kernel_of(env, solver: str) -> str:
    stack = env.config.pallas_block_mode == "stack" and env.config.pallas_block_envs > 1
    base = "fdm_cheby" if solver == "pallas_cheby" else "fdm_jacobi"
    return base + "_block" if stack else base


def word_conv(env, keys, words: bool):
    """Fused swap convection of the path (mix32 keys), or with `words` the
    threefry word plane of the same keys."""
    from sbsim_tpu_torch.physics import convection, fdm_cuda

    c = env.convection
    conv = fdm_cuda.ConvInputs(offsets=c.offsets, lead=env._conv_lead, foll=env._conv_foll)
    if not words and env._conv_word_params is not None:
        return dataclasses.replace(conv, word_params=env._conv_word_params, keys=keys)
    plane = convection.swap_decision_word(dataclasses.replace(c, rng="threefry"), keys,
                                          env.geom.shape)
    return dataclasses.replace(conv, words=fdm_cuda.packed_plane(plane, env.device))


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


def run_kernel(name, env, inp, conv, limit, plain=False, stats=None, e=None):
    """Kernel `name` (its plain version with `plain`) on the env's solver
    settings; K3/K4 with `e` envs per thread block (default: the env's)."""
    from sbsim_tpu_torch.physics import fdm_cuda

    kw = dict(threshold=env.config.convergence_threshold, iteration_limit=limit,
              conv=conv, stats=stats)
    if name.startswith("fdm_cheby"):
        kw.update(spectral_radius=env._spectral_radius,
                  check_every=env.config.cheby_check_every)
    if name.endswith("_block"):
        kw.update(block_envs=e or block_envs(env, name))
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
    """Within the block, every kernel wrapper runs its plain version."""

    def __enter__(self):
        from sbsim_tpu_torch.physics import fdm_cuda

        self.saved = {k: getattr(fdm_cuda, f"{k}_cuda") for k in KERNELS}
        for k in KERNELS:
            setattr(fdm_cuda, f"{k}_cuda", getattr(fdm_cuda, f"{k}_plain"))

    def __exit__(self, *exc):
        from sbsim_tpu_torch.physics import fdm_cuda

        for k, fn in self.saved.items():
            setattr(fdm_cuda, f"{k}_cuda", fn)


def _profile_window(fn, label, tag):
    """Device busy time and launches of one call of fn (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"    {label}: wall {wall_us / 1e3:.3f} ms, device busy not measured (the "
              f"profiler recorded no device event) {tag}", flush=True)
        return out
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"    {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"(idle {1 - busy / wall_us:.1%}), {len(kernels)} kernel launches {tag}", flush=True)
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
    if counts != {k: (env_steps if k == kname else 0) for k in KERNELS}:
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
    launches = dict.fromkeys(KERNELS, 0)
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
        conv = word_conv(env, conv_keys, env._conv_word_params is None) if fused else None
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
                kw = dict(threshold=-1.0, iteration_limit=limit, conv=None)
                if family == "cheby":
                    kw.update(spectral_radius=env._spectral_radius,
                              check_every=env.config.cheby_check_every)
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
        cuobjdump = os.path.join(os.path.dirname(fdm_cuda._nvcc()), "cuobjdump")
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
    """Within the block: SACTrainer._maybe_reset records each collect
    step's `done` and, where an env finished, holds the reset envs against
    env.reset on the same keys (bitwise); seeding steps and train_steps are
    timed with CUDA events."""

    def __init__(self):
        self.done, self.step_idx, self.reset_diffs = [], [], []
        self.seed_events, self.train_events = [], []

    def __enter__(self):
        import torch
        from sbsim_tpu_torch import rng
        from sbsim_tpu_torch.agents import train

        cls = train.SACTrainer
        self.saved = {k: getattr(cls, k) for k in ("_maybe_reset", "seed_with_actions",
                                                   "train_step")}
        spies = self

        def timed(fn, events):
            def call(*args, **kwargs):
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(*args, **kwargs)
                e.record()
                events.append((s, e))
                return out
            return call

        def maybe_reset(trainer, env_states, obs, done, key):
            new_states, new_obs = spies.saved["_maybe_reset"](trainer, env_states, obs, done, key)
            spies.done.append(done.cpu())
            spies.step_idx.append(new_states.step_idx.cpu())
            if bool(done.any()):
                from sbsim_tpu_torch import convert
                fresh, fresh_obs = trainer.env.reset(rng.split(key, trainer.config.n_envs))
                rows = done.nonzero().flatten()
                sel = lambda d: {k: (sel(v) if isinstance(v, dict) else v[rows.cpu().numpy()])
                                 for k, v in d.items()}
                diff = _tree_diff(sel(convert.env_state_to_numpy(fresh)),
                                  sel(convert.env_state_to_numpy(new_states)))
                if not torch.equal(fresh_obs[rows], new_obs[rows]):
                    diff.append(("observation", float((fresh_obs[rows] - new_obs[rows]).abs().max())))
                spies.reset_diffs.append((len(spies.done), int(rows.numel()), diff))
            return new_states, new_obs

        def seed_with_actions(trainer, state, table):
            return timed(spies.saved["seed_with_actions"](trainer, state, table),
                         spies.seed_events)

        cls._maybe_reset = maybe_reset
        cls.seed_with_actions = seed_with_actions
        cls.train_step = timed(self.saved["train_step"], self.train_events)
        return self

    def __exit__(self, *exc):
        from sbsim_tpu_torch.agents import train

        for k, fn in self.saved.items():
            setattr(train.SACTrainer, k, fn)


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
        if counts != {k: (env_steps if k == "fdm_jacobi" else 0) for k in KERNELS}:
            fail(f"train_sac: launch counts {counts} != {env_steps} fdm_jacobi env steps")
        collects = seed_steps + train_steps
        done = torch.stack(spies.done)  # (collect steps, n_envs)
        fired = done.any(1).nonzero().flatten().tolist()
        if len(spies.done) != collects or fired != [episode - 1] or not bool(
                done[episode - 1].all()):
            fail(f"train_sac: done fired at collect steps {[i + 1 for i in fired]} "
                 f"(all envs at {episode}: {bool(done[episode - 1].all())})")
        after = spies.step_idx[seed_steps - 1]
        if after.tolist() != [seed_steps - episode] * n_envs:
            fail(f"train_sac: step_idx after seeding step {seed_steps} is {after.unique()}")
        if [(at, n) for at, n, _ in spies.reset_diffs] != [(episode, n_envs)] or any(
                d for _, _, d in spies.reset_diffs):
            fail(f"train_sac: the reset envs differ from env.reset: {spies.reset_diffs}")
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
    if counts != {k: (want if k == "fdm_jacobi" else 0) for k in KERNELS} or any(
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
        conv = word_conv(env, conv_keys, env._conv_word_params is None) if fused else None
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


def host_run(env, policy, steps, plain):
    """HostEnvironment over SimulatedBuilding(env, seed=0) recording into a
    temporary directory: reset, then `steps` control steps with the policy's
    actions, through the kernels or (with `plain`) their plain versions.
    Returns the time steps, the metrics, the record files by name, the
    messages written, the episode data, the launch counts and the CUDA
    events of each step and of its wait_time."""
    import tempfile

    import torch
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
            plain_kernels() if plain else contextlib.nullcontext()):
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
    if got["counts"] != {k: (steps if k == kname else 0) for k in KERNELS} or any(
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
    launches = dict.fromkeys(KERNELS, 0)
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
                                        for k in KERNELS}:
        fail(f"step at B=1: launch counts {fdm_cuda.launch_counts}")
    launches["fdm_jacobi"] += n
    print(f"  step at B=1 ({ROW_STEPS} steps from env {ROW} of B={b}): state and outputs bitwise "
          f"row {ROW} of step_batched through fdm_jacobi; K2 launches {n} ({ROW_STEPS} at B=1, "
          f"{ROW_STEPS} at B={b})", flush=True)
    print(f"  phase 7 in {time.time() - t_start:.1f} s", flush=True)
    return launches


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
    from sbsim_tpu_torch.physics import fdm_cuda

    t_start = time.time()
    # ---- Phase 0 ---------------------------------------------------------
    card = card_line()
    name = torch.cuda.get_device_name(0)
    tag = f"[{card}]"
    nvcc = subprocess.run([fdm_cuda._nvcc(), "--version"], capture_output=True,
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
    max_err = dict.fromkeys(KERNELS, 0.0)
    check_phase(envs, max_err)
    launches, timing = main_path_phase(envs, max_err, bw, flops, tag)
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
