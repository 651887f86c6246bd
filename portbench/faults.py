"""The controls and planted faults that the comparison must catch.

A control is the reference one precision below the configuration's
float32 put in the program's place, or the program with such a path of
its own switched on: the rollout cells' reference step (portbench/oracle)
with every float of its state stored in bfloat16, and the train cells'
program with TF32 matrix products. A fault is the program with its timed
path broken underneath: a step that returns its state unchanged, half of
the batch left out (the mean taken over the rest), and an answer altered
where it is produced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import torch

ROLLOUT_FAULTS = ("unchanged", "half_batch", "altered")
TRAIN_FAULTS = ("unchanged", "half_batch", "altered")
# Added to the rollout call's mean reward, and to every env's reward in the
# train cells, by the "altered" faults (rewards lie in [-1, 0], about -0.02
# in these cells).
ALTERED_REWARD = 0.01


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        rx, rw = _round_tf32(x), _round_tf32(w)
        ctx.save_for_backward(rx, rw)
        ctx.has_bias = b is not None
        y = rx @ rw.t()
        return y + b if b is not None else y

    @staticmethod
    def backward(ctx, g):
        rx, rw = ctx.saved_tensors
        rg = _round_tf32(g)
        gx = rg @ rw
        gw = rg.reshape(-1, rg.shape[-1]).t() @ rx.reshape(-1, rx.shape[-1])
        gb = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


@contextlib.contextmanager
def tf32_products():
    """Within the block every torch.nn.functional.linear rounds its operands
    to TF32 and sums in float32, as the tensor cores do with TF32 on: the
    train cells' control where the card's own TF32 path is not at hand
    (the CPU)."""
    f = torch.nn.functional
    linear = f.linear
    f.linear = lambda x, w, b=None: _TF32Linear.apply(x, w, b)
    try:
        yield
    finally:
        f.linear = linear


def tf32_training(system):
    """The program's training system with its matrix products in TF32: on
    the card its own TF32 path (torch.backends.cuda.matmul.allow_tf32)
    switched on around each of its calls, captures included; on the CPU
    emulated by tf32_products. The reference's own calls stay in float32."""
    seed_fn, step = system.seed_fn, system.step
    card = system.device.type == "cuda"

    @contextlib.contextmanager
    def tf32():
        if not card:
            with tf32_products():
                yield
            return
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag

    def wrap(fn):
        def run(state):
            with tf32():
                return fn(state)
        return run

    system.seed_fn = wrap(seed_fn)
    stepped = wrap(step)
    stepped.sides = [wrap(side) for side in step.sides]
    system.step = stepped
    return system


def _tree(state, fn):
    """`state` (a dataclass or namespace tree) with `fn` applied to every
    tensor leaf."""
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{f.name: _tree(getattr(state, f.name), fn)
                                             for f in dataclasses.fields(state)})
    if isinstance(state, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: _tree(v, fn) for k, v in vars(state).items()})
    return fn(state) if torch.is_tensor(state) else state


def select(state, idx: torch.Tensor):
    """The envs `idx` of a batched state."""
    return _tree(state, lambda x: x.index_select(0, idx))


def _concat(a, b):
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{f.name: _concat(getattr(a, f.name), getattr(b, f.name))
                                         for f in dataclasses.fields(a)})
    return torch.cat([a, b])


class ReferenceRollout:
    """The rollout cells' control: the reference's step in the program's
    place, its state stored in bfloat16 after every step and at reset."""

    def __init__(self, spec, traffic, device, actions):
        from portbench import harness

        self.device = device
        self.b = harness.oracle_building(spec, device)
        self.rho = harness.spectral_radius(spec, self.b)
        self.table = torch.as_tensor(actions, device=device)
        self.steps = traffic["steps_per_call"]

    @staticmethod
    def _round(state):
        return _tree(state, lambda x: x.to(torch.bfloat16).to(torch.float32)
                     if x.is_floating_point() else x)

    def reset(self, keys):
        from portbench.oracle import step as ostep

        return self._round(ostep.reset_state(self.b, keys.to(self.device)))

    def call(self, states):
        from portbench.oracle import step as ostep

        rewards = []
        for _ in range(self.steps):
            t = states.step_idx.to(torch.int64).clamp(0, self.table.shape[0] - 1)
            ref = ostep.step(self.b, states, self.table[t], None, self.rho)
            states = self._round(ostep.next_state(ref, states.occupants))
            rewards.append(ref["reward"].to(torch.bfloat16).float())
        return states, torch.stack(rewards).mean()

    def close(self) -> None:
        pass


def rollout_fault(system, kind: str):
    """The program's rollout system with `kind` planted in its call."""
    call = system.call

    def unchanged(states):
        _, mean = call(states)
        return states, mean

    def half_batch(states):
        b = states.temp.shape[0]
        lo = torch.arange(b // 2, device=states.temp.device)
        hi = torch.arange(b // 2, b, device=states.temp.device)
        stepped, mean = call(select(states, lo))
        return _concat(stepped, select(states, hi)), mean

    def altered(states):
        states, mean = call(states)
        return states, mean + ALTERED_REWARD

    system.call = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}[kind]
    return system


def train_fault(system, kind: str):
    """The program's training system with `kind` planted (before its
    programs are captured)."""
    trainer = system.trainer
    if kind == "unchanged":
        step = system.step

        def unchanged(state):
            new, metrics = step(state)
            return state.replace(env_steps=new.env_steps), metrics

        unchanged.sides = step.sides
        system.step = unchanged
    elif kind == "half_batch":
        update = trainer.learner.update

        def half(sac, batch, key, **kw):
            n = batch.reward.shape[0] // 2
            return update(sac, batch.map(lambda x: x[:n]), key, **kw)

        trainer.learner.update = half
    elif kind == "altered":
        env = trainer.env
        step_batched = env.step_batched

        def altered(states, actions, **kw):
            states, out = step_batched(states, actions, **kw)
            return states, dataclasses.replace(out, reward=out.reward + ALTERED_REWARD)

        env.step_batched = altered
    else:
        raise ValueError(f"unknown fault {kind!r}")
    return system
