"""Train traffic: SAC training as `examples/train_sac.py` runs it on one
card.

Set-up builds one trainer from the seed (`SACTrainer(env, recipe_for(env,
n_envs, batch_size, replay_capacity, seed_steps=0))`), seeds the replay
with the schedule table (`seed_with_actions`, seed_episodes_steps / n_envs
captured calls), and takes the first three learning steps through the
window's own call (`captured_train_step`), keeping what they produced.
The window then runs back-to-back train steps on that same state (each
one collect step with the policy acting, auto-reset at episode ends, and
one SAC update). The rate is every env step collected in the window over
the window's seconds.

Correctness: every env step of the set-up and two of the window (in
comfort hours while occupants arrive, and in the afternoon while they
leave) worked out again by portbench/oracle from the program's state
before it under the action it wrote to the replay: the state after it,
and the reward, discount and observation it wrote; the first reset and
its observation likewise. The three
learning steps followed by the frozen plain SAC update from its own
initial parameters on the program's replay: each step's losses, the
first update's gradient norms as Adam got them, and the parameters'
change over the three.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import compare, harness, inputs, yardstick
from portbench.oracle import observe
from portbench.oracle import step as ostep

# Learning steps the reference follows.
FOLLOWED_STEPS = 3
# Episode steps of the window's compared env steps: 09:00 and 15:50 local.
WINDOW_COMPARED = (108, 190)
# Train steps profiled after the window with --trace 1, and the calls timed
# per side of the update gate for collect_ms / update_ms.
PROFILE_STEPS = 20
SIDE_CALLS = 40
LOSSES = ("critic_loss", "actor_loss", "alpha_loss")


def _key(seed: int) -> torch.Tensor:
    return inputs.key_rows(seed, 100, 1)[0]


def _trained(sac) -> Dict[str, torch.Tensor]:
    """The trained parameters of a SACState, by name."""
    out = {f"actor.{k}": v for k, v in sac.actor_params.items()}
    out.update({f"critic.{k}": v for k, v in sac.critic_params.items()})
    out["log_alpha"] = sac.log_alpha
    return out


def _first_grads(sac) -> Dict[str, torch.Tensor]:
    """The first update's gradients as Adam got them: mu / (1 - b1) after
    one step (optax's first moment starts at zero)."""
    b1 = 0.9
    out = {f"actor.{k}": v / (1 - b1) for k, v in sac.actor_opt.mu.items()}
    out.update({f"critic.{k}": v / (1 - b1) for k, v in sac.critic_opt.mu.items()})
    out["log_alpha"] = sac.alpha_opt.mu / (1 - b1)
    return out


def _copy(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tree.items()}


def _row(replay) -> Dict[str, torch.Tensor]:
    """The replay row the last collect step wrote, every env's (a copy;
    the slot found on the device)."""
    cap = replay.per_env_capacity
    idx = ((replay.insert_index.to(torch.int64) + cap - 1) % cap).view(1)
    return {f.name: getattr(replay.data, f.name).index_select(1, idx)[:, 0].clone()
            for f in dataclasses.fields(replay.data)}


@dataclasses.dataclass
class Kept:
    """What the program's set-up and window produced, for the reference."""

    reset: object  # the first env states
    steps: List[Tuple[object, object, Dict[str, torch.Tensor]]]  # (before, after, row)
    losses: List[Dict[str, float]]
    grads: Dict[str, torch.Tensor]
    params0: Dict[str, torch.Tensor]
    params3: Dict[str, torch.Tensor]
    replay: Dict[str, torch.Tensor]  # the first slots of every env's sub-ring
    per_env_capacity: int


class ProgramTraining:
    """The system under test: the program's trainer and its captured
    seeding and train steps."""

    def __init__(self, spec, traffic, device, table: np.ndarray, seed: int):
        from sbsim_tpu_torch.agents.train import SACTrainer, recipe_for
        from sbsim_tpu_torch.envs.building_env import BuildingEnv

        env = BuildingEnv(harness.env_config(spec), device=device)
        harness.check_env(spec, env)
        self.trainer = SACTrainer(env, recipe_for(
            env, n_envs=traffic["n_envs"], batch_size=traffic["batch_size"],
            replay_capacity=traffic["replay_capacity"], env_solver=traffic["solver"],
            seed_steps=0))
        check_recipe(traffic, self.trainer.config)
        self.device = env.device
        self.state = self.trainer.init(_key(seed).to(device))
        self.seed_fn = self.trainer.seed_with_actions(None, table)
        self.step = self.trainer.captured_train_step()

    def close(self) -> None:
        from sbsim_tpu_torch import graphs

        graphs.release()


def check_recipe(traffic, cfg) -> None:
    """Raises unless the program trains with the mix's recipe."""
    sac = {k: (list(v) if isinstance(v, tuple) else v)
           for k, v in dataclasses.asdict(cfg.sac).items()}
    got = {"n_envs": cfg.n_envs, "batch_size": cfg.batch_size,
           "replay_capacity": cfg.replay_capacity, "solver": cfg.env_solver,
           "updates_per_env_step": cfg.updates_per_env_step,
           "sac": {k: sac[k] for k in traffic["sac"]}}
    want = {k: traffic[k] for k in got}
    if got != want or cfg.replay_layout != "per_env" or cfg.seed_steps != 0:
        raise ValueError(f"the program's recipe {got} is not the mix's {want}")


def _setup(system, n_seed: int) -> Tuple[object, Kept]:
    """Seeding, then the first learning steps, keeping what they made."""
    state = system.state
    first = state.env_states
    steps = []
    for _ in range(n_seed):
        before = state.env_states
        state, _ = system.seed_fn(state)
        steps.append((before, state.env_states, _row(state.replay)))
    params0 = _copy(_trained(state.sac))
    losses, grads = [], None
    for i in range(FOLLOWED_STEPS):
        before = state.env_states
        state, metrics = system.step(state)
        steps.append((before, state.env_states, _row(state.replay)))
        losses.append({k: float(metrics[k]) for k in LOSSES})
        if i == 0:
            grads = _copy(_first_grads(state.sac))
    n = n_seed + FOLLOWED_STEPS
    replay = {f.name: getattr(state.replay.data, f.name)[:, :n].clone()
              for f in dataclasses.fields(state.replay.data)}
    return state, Kept(reset=first, steps=steps, losses=losses, grads=grads, params0=params0,
                       params3=_copy(_trained(state.sac)), replay=replay,
                       per_env_capacity=state.replay.per_env_capacity)


def run(c: harness.Cell, *, seed: int, seconds: float, trace: bool, t_start: float,
        system=None) -> harness.Outcome:
    """One run of a train cell. `system` stands in for the program (the
    tests' rehearsal, the control and the planted faults)."""
    traffic, spec = c.traffic, c.config
    dev = torch.device("cuda", 0) if system is None else system.device
    table = inputs.schedule_table(spec, traffic)
    system = system or ProgramTraining(spec, traffic, dev, table, seed)
    n_envs = traffic["n_envs"]
    n_seed = max(1, traffic["seed_episodes_steps"] // n_envs)
    episode = harness.episode_steps(spec)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    state, kept = _setup(system, n_seed)
    sync()

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps, done_at = 0, n_seed + FOLLOWED_STEPS
    sampler = harness.CallSampler(cuda)
    while True:
        before = state.env_states
        with sampler:
            state, _ = system.step(state)
        steps += 1
        if (done_at + steps - 1) % episode in WINDOW_COMPARED and steps < episode:
            kept.steps.append((before, state.env_states, _row(state.replay)))
        if steps % 16 == 0 and time.perf_counter() - t0 >= seconds:
            break
    launched = time.perf_counter()
    sync()
    window_s = time.perf_counter() - t0
    print(f"window: {steps} steps, {window_s:.3f} s, the last {window_s - (launched - t0):.3f} s "
          f"waiting for the device; {sampler.report()}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    profiled = sides = None
    if trace and cuda:
        state, profiled = _profile(system, state, PROFILE_STEPS)
        state, collect_ms = _side_ms(system.step.sides[0], state, SIDE_CALLS)
        state, learn_ms = _side_ms(system.step.sides[1], state, SIDE_CALLS)
        sides = (collect_ms, learn_ms)
    del state, before
    system.state = None
    system.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # The reference, once the window has closed.
    b = harness.oracle_building(spec, dev)
    rho = 0.0 if spec["fdm_work"][traffic["solver"]]["method"] == "jacobi" \
        else harness.spectral_radius(spec, b)
    values, (iters, layers) = check(b, rho, spec, traffic, seed, kept)
    rate = steps * n_envs / window_s
    outcome = harness.Outcome(
        attempted=steps * n_envs, failed=0,
        end_to_end={"train_env_steps_per_s": rate, "setup_s": setup_s},
        comparisons=compare.comparisons(values, compare.TRAIN_LIMITS),
        memory_peak_bytes=int(peak))
    if profiled is not None:
        _traced(outcome, b, spec, traffic, profiled, sides, iters, layers, rate)
    return outcome


def check(b, rho, spec, traffic, seed, kept: Kept):
    """The comparison values, and (the reference's mean FDM iterations per
    env of the compared steps, the SAC networks' dense layers)."""
    gaps = compare.StepGaps()
    dev = b.device
    n_envs = traffic["n_envs"]
    n_seed = max(1, traffic["seed_episodes_steps"] // n_envs)
    key = _key(seed).to(dev).view(1, 2)
    env_key = ostep.subkey(key, 0)
    keys = torch.cat([ostep.subkey(env_key, i) for i in range(n_envs)])
    gaps.state_pair(compare.program_leaves(b, kept.reset),
                    compare.program_leaves(b, ostep.reset_state(b, keys)))
    gaps.mismatch += int(ostep.illegal_at_reset(b, kept.reset.occupants).sum())
    first = kept.steps[0][2]["obs"]
    people = kept.reset.occupants.sum(dim=(1, 2))
    gaps.state_pair({"reset_obs": first}, {"reset_obs": observe.observation(
        b, kept.reset, kept.reset.step_idx.to(torch.int64), people)})
    iters = []
    discount = torch.tensor(float(spec["discount_factor"]), dtype=torch.float32, device=dev)
    for k, (before, after, row) in enumerate(kept.steps):
        if 0 < k < n_seed + FOLLOWED_STEPS:  # set-up rows follow one another
            gaps.mismatch += int((row["obs"] != kept.steps[k - 1][2]["next_obs"]).sum())
        ref = ostep.step(b, before, row["action"], after, rho)
        gaps.state_pair(compare.program_leaves(b, after), compare.reference_leaves(ref))
        gaps.rewards(row["reward"], ref["reward"])
        done = ref["step_idx"] >= b.n_steps
        # The discount is stored in float32, as the configuration's factor is.
        want = torch.where(done, torch.zeros_like(discount), discount)
        gaps.mismatch += int((row["discount"].to(torch.float32) != want).sum())
        gaps.mismatch += int(ostep.illegal_moves(b, before, after.occupants).sum())
        gaps.mismatch += observation_gaps(gaps, b, before, after, row)
        iters.append(float(ref["iterations"].double().mean()))
    if len(kept.steps) < n_seed + FOLLOWED_STEPS + len(WINDOW_COMPARED):
        gaps.mismatch += 1  # a compared step never ran
    print("compared leaves (worst): " + ", ".join(f"{k} {v:.3g}" for k, v in
                                                  sorted(gaps.worst.items())), file=sys.stderr)
    values = gaps.values()
    sac_values, layers = follow_sac(traffic, seed, kept, dev)
    values.update(sac_values)
    return values, (float(np.mean(iters)), layers)


def observation_gaps(gaps, b, before, after, row) -> int:
    """The observation the step wrote as `next_obs`, worked out from the
    program's state after the step: every field but the occupant count
    into the state gaps; the count, drawn between the step's two draws,
    checked against its bounds (returned: envs outside them)."""
    t1 = before.step_idx.to(torch.int64) + 1
    least, most = observe.occupants_between(b, before, after.occupants)
    ref = observe.observation(b, after, t1, least)
    got = row["next_obs"]
    gaps.state_pair({"next_obs": got[:, :-1]}, {"next_obs": ref[:, :-1]})
    c = b.spec["observation"]["occupancy_normalization_constant"]
    count = got[:, -1].double() * (c + 1.0) + c
    return int(((count < least) | (count > most)).sum())


def _layers(module) -> List[Tuple[int, int]]:
    """(in, out) of every dense layer of a module, in order."""
    return [(m.in_features, m.out_features) for m in module.modules()
            if isinstance(m, torch.nn.Linear)]


def follow_sac(traffic, seed, kept: Kept, dev):
    """The plain SAC update from its own initial parameters over the
    learning steps, on the program's replay as each step sampled it: the
    comparison values, and the dense layers of the actor and of one
    critic."""
    from portbench.oracle.sac import replay as replay_lib
    from portbench.oracle.sac import rng as rng_lib
    from portbench.oracle.sac.sac import SACConfig, SACLearner as SAC

    n_envs = traffic["n_envs"]
    n_seed = max(1, traffic["seed_episodes_steps"] // n_envs)
    cfg = {k: (tuple(v) if isinstance(v, list) else v) for k, v in traffic["sac"].items()}
    obs_dim, act_dim = kept.replay["obs"].shape[-1], kept.replay["action"].shape[-1]
    learner = SAC(obs_dim, act_dim, SACConfig(**cfg), device=dev)
    k_env, k_sac, rng = rng_lib.split(_key(seed).to(dev), 3)
    sac = learner.init(k_sac)
    params0 = _copy(_trained(sac))
    cap = kept.per_env_capacity
    data = {}
    for name, rows in kept.replay.items():
        buf = torch.zeros((n_envs, cap) + rows.shape[2:], dtype=rows.dtype, device=dev)
        buf[:, :rows.shape[1]] = rows.to(dev)
        data[name] = buf
    transition = replay_lib.Transition(**data)
    for _ in range(n_seed):
        rng = rng_lib.split(rng, 3)[0]
    losses, grads = [], None
    for i in range(FOLLOWED_STEPS):
        rng = rng_lib.split(rng, 3)[0]
        rng, k_updates = rng_lib.split(rng)
        for key in rng_lib.split(k_updates, traffic["updates_per_env_step"]):
            k_sample, k_update = rng_lib.split(key)
            size = torch.tensor(n_seed + i + 1, dtype=torch.int32, device=dev)
            replay = replay_lib.ShardedReplayState(
                data=transition, insert_index=size, size=size, per_env_capacity=cap)
            batch = replay_lib.sample_sharded(replay, k_sample, traffic["batch_size"])
            sac, metrics = learner.update(sac, batch, k_update)
        losses.append({k: float(metrics[k]) for k in LOSSES})
        if i == 0:
            grads = _copy(_first_grads(sac))
    params3 = _copy(_trained(sac))
    loss_gap = max(abs(p[k] - r[k]) / max(abs(r[k]), 1.0)
                   for p, r in zip(kept.losses, losses) for k in LOSSES)
    if not all(np.isfinite(p[k]) for p in kept.losses for k in LOSSES):
        loss_gap = float("inf")
    start_gap = max(float((kept.params0[k].to(dev) - params0[k]).abs().max()) for k in params0)
    moved = compare.moved_leaves(grads)
    change = lambda p3, p0: {k: p3[k].to(dev) - p0[k].to(dev) for k in p0}
    critic = _layers(learner.critic)
    layers = (_layers(learner.actor), critic[:len(critic) // 2])
    return {
        "loss_gap": loss_gap if start_gap == 0 else float("inf"),
        "grad_norm_gap": compare.gap_of_norms({k: v.to(dev) for k, v in kept.grads.items()},
                                              grads, list(grads)),
        "param_change_gap": compare.gap_of_norms(change(kept.params3, kept.params0),
                                                 change(params3, params0), moved),
    }, layers


def _profile(system, state, steps: int):
    """(state, window): `steps` train steps under torch.profiler, re-profiled
    when a window records no device event."""
    for _ in range(3):
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA],
                                      acc_events=True)
        with prof:
            p0 = time.perf_counter()
            for _ in range(steps):
                with torch.profiler.record_function(harness.LABEL + "train_step"):
                    state, _ = system.step(state)
            torch.cuda.synchronize()
            p1 = time.perf_counter()
        w = harness.profiled_window(prof, p0, p1)
        if w is not None:
            return state, w
    return state, None


def _side_ms(side, state, calls: int):
    """(state, ms per call) of one side of the update gate called alone,
    after a warm-up call, timed by CUDA events."""
    state, _ = side(state)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        state, _ = side(state)
    end.record()
    end.synchronize()
    return state, start.elapsed_time(end) / calls


def _traced(outcome, b, spec, traffic, window, sides, iters, layers, rate) -> None:
    """The per-layer trace: the whole iteration's counted work at the
    window's untraced rate, the profiled steps' kernels and the sides'
    times."""
    from portbench.drivers.rollout import solve_shape

    kind = torch.cuda.get_device_name(0)
    flops = yardstick.peaks(kind)[1][1]
    n_envs = traffic["n_envs"]
    actor, critic = layers
    shape = solve_shape(spec, b, traffic["solver"], n_envs)
    step_flops = (yardstick.fdm_work(shape, iters * n_envs)[1]
                  + yardstick.mlp_flops(actor, n_envs)
                  + yardstick.sac_update_flops(actor, critic, traffic["batch_size"])
                  * traffic["updates_per_env_step"])
    outcome.trace = {
        "kind": "train", "window": window, "steps": PROFILE_STEPS,
        "step_flops": step_flops, "steps_per_s": rate / n_envs, "peak_flops": flops,
        "collect_ms": sides[0], "update_ms": sides[1] - sides[0],
    }
    outcome.busy_s = yardstick.busy_us(window) / 1e6
    outcome.window_s = window.wall_us / 1e6
    outcome.breakdown = {"device_ops": [list(x) for x in yardstick.top_ops(window)],
                         "idle_gaps": [list(x) for x in yardstick.idle_gaps(window)]}
