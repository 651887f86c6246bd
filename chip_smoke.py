#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sbsim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  0. CUDA runtime, nvcc and card (name and power limit, from nvidia-smi).
  1. Build the CUDA kernels K1 (fdm_cheby), K2 (fdm_jacobi), K3
     (fdm_jacobi_block) and K4 (fdm_cheby_block) from sbsim_tpu_torch/csrc
     with nvcc for sm_90a.
  2. Each kernel against its plain PyTorch version on the card, at the
     12-zone (B=64, and B=62 for a partial last block of K3/K4) and
     126-room (B=16, 189x124; K3/K4 at E=1) plan shapes, with and without
     fused mix32 convection, with a threefry word plane, with a capped
     iteration limit, and with the zone-statistics epilogue (also with
     windows that need several passes of its scratch plane): fields,
     iteration counts, converged flags and zone/grid sums must be bitwise
     equal; K3/K4 must also equal K2/K1 env for env.
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
     statistics and with the word plane; K3/K4 beside K2/K1 and at
     E = 2, 4, 8), with its thread blocks resident per SM; and a
     torch.profiler breakdown of 4 more steps (device busy and idle share,
     kernels by device time).
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
     its env step and its update. Then 3 train_steps at n_envs=8 through
     the kernels and through the plain versions on the card: env states
     and replay contents bitwise equal.
  6. A {"kernels": [...]} line, then the last line
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
BLOCK_SWEEP = (2, 4, 8)


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


def block_envs(env) -> int:
    """The envs per thread block K3/K4 run for this env's config."""
    from sbsim_tpu_torch.physics import fdm_cuda

    return fdm_cuda.effective_block_envs(env.geom.shape, env.config.pallas_block_envs)


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
        kw.update(block_envs=e or block_envs(env))
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


def _check_equal_trees(label, a, b) -> None:
    import numpy as np

    flat = lambda d, p="": [(p + k, v) for k, v in d.items() if not isinstance(v, dict)] + [
        x for k, v in d.items() if isinstance(v, dict) for x in flat(v, p + k + ".")]
    diff = [k for (k, x), (_, y) in zip(flat(a), flat(b)) if not np.array_equal(x, y)]
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
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"    {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"(idle {1 - busy / wall_us:.1%}), {len(kernels)} kernel launches {tag}", flush=True)
    return out


def training_phase(env, kname, n_envs, seed_steps, train_steps, eval_steps, max_err,
                   tag) -> int:
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
    k_ms = time_call(lambda: run_kernel(kname, env, inp, conv, limit, stats=env._stats), 20)
    print(f"  {kname} alone at B={n_envs}: {k_ms:.4f} ms {tag}", flush=True)

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


def check_phase(envs, max_err) -> None:
    """Phase 2: every kernel against its plain version; K3/K4 also against
    K2/K1 env for env."""
    print("phase 2: kernels vs plain versions on the card", flush=True)
    for which, batch in CHECK_SHAPES:
        env = envs[which]
        e = block_envs(env)
        print(f" {which}: grid {env.geom.shape}, B={batch}, block envs {e}, "
              f"rounds={len(env.convection.offsets)}, rho={env._spectral_radius:.6f}",
              flush=True)
        for kname in KERNELS:
            if batch % e and kname in SOLO.values():
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
        e_note = f", {block_envs(env)} envs per block" if kname in SOLO else ""
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
            occ = fdm_cuda.blocks_per_sm(name, env.geom.shape, e or block_envs(env))
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
            # other block widths (12 zones, where up to 8 envs fit).
            solo = run_kernel(SOLO[kname], env, inp, conv, limit, stats=stats)
            compare(f"{kname} vs {SOLO[kname]} at {label} B={batch}", got, solo)
            s_ms = time_call(
                lambda: run_kernel(SOLO[kname], env, inp, conv, limit, stats=stats), 20)
            occ = fdm_cuda.blocks_per_sm(SOLO[kname], env.geom.shape)
            print(f"  {SOLO[kname]} alone on the same inputs: {s_ms:.4f} ms; {occ} blocks "
                  f"per SM {tag}", flush=True)
            if label == "12zone stack":
                for e in BLOCK_SWEEP:
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
    lib = fdm_cuda._library()
    print(f"phase 1: built {os.path.relpath(path, REPO)} in {time.time() - t0:.1f} s; "
          f"max cells {lib.fdm_max_cells()}", flush=True)
    for line in fdm_cuda.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    envs = {which: make_env(which, dev) for which in _PLANS}
    max_err = dict.fromkeys(KERNELS, 0.0)
    check_phase(envs, max_err)
    launches, timing = main_path_phase(envs, max_err, bw, flops, tag)
    wiring_phase(envs)

    # ---- Phase 5 ---------------------------------------------------------
    print("phase 5: SAC training at full width", flush=True)
    for which, kname, n_envs, seed_steps, train_steps, eval_steps in TRAINING:
        launches[kname] += training_phase(envs[which], kname, n_envs, seed_steps,
                                          train_steps, eval_steps, max_err, tag)

    # ---- Phase 6 ---------------------------------------------------------
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
