"""Rollout traffic: a batch of buildings stepped in lockstep under the
schedule policy's action table, the data-collection loop of users who
quote env-steps/s.

The window runs back-to-back calls of the program's rollout entry
(`sbsim_tpu_torch.bench.make_rollout`: `steps_per_call` step_batched calls
as one captured program, one step per call as a loop whose policy acts at
every step calls it); when an episode's steps are done, the batch is reset
from the seed (`BuildingEnv.reset`) inside the window. The rate is every
env step completed over the window's seconds, the resets' time included.

Correctness (portbench/oracle): the first two episodes' reset states, and
the steps of the first episode at COMPARED_STEPS, every env of the batch,
each worked out again from the program's state before it under the
table's action: the field room by room, the zone and grid means, the
diffuser heat, every HVAC and boiler value, the keys, the occupants'
moves and the call's mean reward.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import numpy as np
import torch

from portbench import compare, harness, inputs, yardstick
from portbench.oracle import step as ostep

# Steps of the first episode compared (local time from midnight at 5 min a
# step): the first, from the reset; 09:00, in comfort hours while
# occupants arrive; 15:50, in the afternoon while they leave.
COMPARED_STEPS = (0, 108, 190)
# Steps of the first episode whose solve the reference repeats to count
# the FDM work of an env step (mfu.rollout).
WORK_STEPS = tuple(range(4, 576, 64))
# Calls profiled after the window with --trace 1.
PROFILE_CALLS = 24


class ProgramRollout:
    """The system under test: the program's env and rollout entry."""

    def __init__(self, spec, traffic, device, actions: np.ndarray):
        from sbsim_tpu_torch import bench
        from sbsim_tpu_torch.envs.building_env import BuildingEnv

        self.env = BuildingEnv(harness.env_config(spec), device=device)
        self.device = self.env.device
        harness.check_env(spec, self.env)
        self.call = bench.make_rollout(self.env, actions, traffic["steps_per_call"],
                                       traffic["solver"])

    def reset(self, keys):
        return self.env.reset(keys)[0]

    def close(self) -> None:
        from sbsim_tpu_torch import graphs

        graphs.release()


def run(c: harness.Cell, *, seed: int, seconds: float, trace: bool, t_start: float,
        system=None) -> harness.Outcome:
    """One run of a rollout cell. `system` stands in for the program (the
    tests' rehearsal, the control and the planted faults)."""
    dev = torch.device("cuda", 0) if system is None else system.device
    spec, traffic = c.config, c.traffic
    batch, per_call = traffic["batch"], traffic["steps_per_call"]
    episode_steps = harness.episode_steps(spec)
    actions = inputs.schedule_table(spec, traffic)
    system = system or ProgramRollout(spec, traffic, dev, actions)
    if episode_steps % per_call:
        raise ValueError("an episode must be a whole number of calls")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)

    # Set-up: the shapes the window uses (the reset, the captured call and
    # its replay).
    states = system.reset(inputs.key_rows(seed, 0, batch).to(dev))
    for _ in range(2):
        states, _ = system.call(states)
    del states
    sync()

    # The window.
    kept: Dict[int, tuple] = {}
    work: Dict[int, object] = {}
    resets: Dict[int, object] = {}
    calls, episode, done = 0, 1, False
    sampler = harness.CallSampler(cuda)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while not done:
        states = system.reset(inputs.key_rows(seed, episode, batch).to(dev))
        if episode <= 2:
            resets[episode] = states
        for t in range(0, episode_steps, per_call):
            before = states
            with sampler:
                states, mean = system.call(states)
            calls += 1
            if episode == 1:
                if t in COMPARED_STEPS:
                    kept[t] = (before, states, mean)
                if trace and t in WORK_STEPS:
                    work[t] = before
            elif time.perf_counter() - t0 >= seconds:
                done = True
                break
        done = done or time.perf_counter() - t0 >= seconds
        episode += 1
    launched = time.perf_counter()
    sync()
    window_s = time.perf_counter() - t0
    env_steps = calls * per_call * batch
    print(f"window: {calls} calls, {episode - 1} episodes, {window_s:.3f} s, the last "
          f"{window_s - (launched - t0):.3f} s waiting for the device; {sampler.report()}",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    profiled = _profile(system, states, PROFILE_CALLS) if trace and cuda else None
    del states, before
    system.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # The reference, once the window has closed.
    b = harness.oracle_building(spec, dev)
    rho = harness.spectral_radius(spec, b)
    values = check(b, rho, seed, batch, actions, resets, kept)
    del resets, kept
    outcome = harness.Outcome(
        attempted=env_steps, failed=0,
        end_to_end={"rollout_env_steps_per_s": env_steps / window_s, "setup_s": setup_s},
        comparisons=compare.comparisons(values, compare.STEP_LIMITS),
        memory_peak_bytes=int(peak))
    if profiled is not None:
        _traced(outcome, b, rho, spec, traffic, work, profiled, env_steps / window_s)
    return outcome


def check(b, rho, seed, batch, actions, resets, kept) -> Dict[str, float]:
    """The comparison values of the kept resets and steps."""
    gaps = compare.StepGaps()
    dev = b.device
    for episode, state in resets.items():
        keys = inputs.key_rows(seed, episode, batch).to(dev)
        gaps.state_pair(compare.program_leaves(b, state),
                        compare.program_leaves(b, ostep.reset_state(b, keys)))
        gaps.mismatch += int(ostep.illegal_at_reset(b, state.occupants).sum())
    table = torch.as_tensor(actions, device=dev)
    for t, (before, after, mean) in sorted(kept.items()):
        act = table[before.step_idx.to(torch.int64).clamp(0, table.shape[0] - 1)]
        ref = ostep.step(b, before, act, after, rho)
        gaps.state_pair(compare.program_leaves(b, after), compare.reference_leaves(ref))
        gaps.rewards(mean.reshape(1), ref["reward"].mean().reshape(1))
        gaps.mismatch += int(ostep.illegal_moves(b, before, after.occupants).sum())
    if len(kept) < len(COMPARED_STEPS):
        gaps.mismatch += 1  # a compared step never ran
    print("compared leaves (worst): " + ", ".join(f"{k} {v:.3g}" for k, v in
                                                  sorted(gaps.worst.items())), file=sys.stderr)
    return gaps.values()


def _profile(system, states, calls: int):
    """`calls` calls after the window under torch.profiler (re-profiled when
    a window records no device event): (window, the calls' input states)."""
    for _ in range(3):
        inputs_seen = []
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA],
                                      acc_events=True)
        with prof:
            p0 = time.perf_counter()
            for _ in range(calls):
                inputs_seen.append(states)
                with torch.profiler.record_function(harness.LABEL + "rollout_call"):
                    states, _ = system.call(states)
            torch.cuda.synchronize()
            p1 = time.perf_counter()
        w = harness.profiled_window(prof, p0, p1)
        if w is not None:
            return w, inputs_seen
    return None


def solve_shape(spec, b, solver: str, batch: int) -> yardstick.SolveShape:
    """The FDM solve one batched step runs, from the configuration."""
    work, conv = spec["fdm_work"][solver], spec["convection"]
    stats = None
    if work["zone_sums"]:
        ids = b.grid.zone_ids
        box = [np.argwhere(ids == z) for z in range(b.grid.n_zones)]
        stats = (b.grid.n_zones, max(int(np.ptp(c[:, 0])) + 1 for c in box),
                 max(int(np.ptp(c[:, 1])) + 1 for c in box))
    mix32 = conv["rng"] == "mix32"
    return yardstick.SolveShape(
        batch=batch, height=b.grid.shape[0], width=b.grid.shape[1], method=work["method"],
        conv_rounds=conv["rounds"], word_rounds=conv["word_planes"] if mix32 else 0,
        word_plane=not mix32, stats=stats)


def _traced(outcome, b, rho, spec, traffic, work, profiled, rate) -> None:
    """The per-layer trace: the profiled calls' kernels, the FDM work of
    their steps and of the first episode's WORK_STEPS by the reference's
    own solve."""
    window, seen = profiled
    per_call, batch, solver = traffic["steps_per_call"], traffic["batch"], traffic["solver"]
    kind = torch.cuda.get_device_name(0)
    bw, flops = yardstick.peaks(kind)[1]
    shape = solve_shape(spec, b, solver, batch)
    iters = lambda s: b.solve(s.temp, s.input_q, s.step_idx.to(torch.int64), rho)[1]
    bound_ms, bound_by = 0.0, {}
    for s in seen:
        total = float(iters(s).double().sum())
        ms, by = yardstick.fdm_bound_ms(shape, total, bw, flops)
        bound_ms += ms * per_call
        bound_by[by] = bound_by.get(by, 0) + 1
    per_env = [float(iters(s).double().mean()) for s in work.values()]
    flops_per_env_step = yardstick.fdm_work(shape, float(np.mean(per_env)) * batch)[1] / batch
    steps = len(seen) * per_call
    print(f"fdm bound: {bound_ms:.4f} ms over {steps} profiled steps; reference iterations "
          f"per env-step {np.mean(per_env):.3f} over the episode", file=sys.stderr)
    outcome.trace = {
        "kind": "rollout", "window": window, "steps": steps,
        "fdm_bound_ms": bound_ms, "fdm_bound_by": max(bound_by, key=bound_by.get),
        "flops_per_env_step": flops_per_env_step, "env_steps_per_s": rate,
        "peak_flops": flops,
    }
    outcome.busy_s = yardstick.busy_us(window) / 1e6
    outcome.window_s = window.wall_us / 1e6
    outcome.breakdown = {"device_ops": [list(x) for x in yardstick.top_ops(window)],
                         "idle_gaps": [list(x) for x in yardstick.idle_gaps(window)]}
