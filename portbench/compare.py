"""The comparisons that decide `correct`, and their limits.

Each limit lies between two readings taken on the H100 at the cells' own
sizes (PERF.md gives them): the largest the program gave over a dozen
seeds or more, and the smallest its control gave (the reference one
precision lower, or the program with its TF32 path on, in the program's
place).
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Dict, List, Sequence, Tuple

import torch

# Env steps, in every cell: the step from the program's state before it,
# under the action it took, worked out again by portbench/oracle.
STEP_LIMITS = {
    # K: the largest gap of the new field (room by room on sorted values,
    # cell by cell outside the rooms), the zone means and the grid mean.
    "temp_gap_K": 0.4,
    # The largest gap of any other float leaf of the new state (diffuser
    # heat, HVAC and boiler values), as a share of that leaf's largest
    # reference magnitude or of 1 in its unit, whichever is larger.
    "state_gap": 3e-4,
    # Elements of the integer and boolean leaves (thermostat modes, request
    # counts, flags, steps, keys) that differ, plus the occupants whose
    # change no arrival or departure window allows.
    "discrete_mismatch": 0.0,
    # The largest gap of a reward (rollout cells: the batch mean of a
    # call; train cells: each env's, as written to the replay), as a share
    # of the largest reference reward magnitude.
    "reward_gap": 1e-4,
}

# Train cells (SACTrainer.captured_train_step): its first three learning
# steps, followed by the plain SAC update on the program's replay.
SAC_LIMITS = {
    # The largest gap of a step's critic, actor or alpha loss, as a share of
    # max(|reference loss|, 1).
    "loss_gap": 3e-5,
    # The worst leaf's |norm(g_program) - norm(g_reference)| of the first
    # update's gradients as Adam got them, over max(that leaf's reference
    # norm, the median leaf's).
    "grad_norm_gap": 3e-4,
    # The same measure on the parameters' change over the three updates,
    # over the leaves whose reference gradient is not nought to rounding.
    "param_change_gap": 4e-4,
}

TRAIN_LIMITS = {**STEP_LIMITS, **SAC_LIMITS}
# Leaves in K, compared by their gap in K.
KELVIN = ("temp.room_sorted", "temp.outside_rooms", "zone_means", "grid_mean")
# Leaves the reference does not work out (the occupants are checked by
# their moves; the solver's own iteration count depends on its method).
NOT_COMPARED = ("temp", "occupants", "fdm_iterations")


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Tensor leaves of nested dataclasses, namespaces and dicts, by dotted
    path."""
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, types.SimpleNamespace):
        items = list(vars(tree).items())
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif torch.is_tensor(tree):
        return {prefix[:-1]: tree}
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}{k}."))
    return out


def _rel(diff: float, scale: float) -> float:
    return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)


def _gap(p: torch.Tensor, r: torch.Tensor) -> float:
    d = (p.double() - r.double().to(p.device)).abs()
    gap = float(d.max()) if d.numel() else 0.0
    return gap if math.isfinite(gap) else math.inf


class StepGaps:
    """Running maxima of the env-step comparisons."""

    def __init__(self):
        self.temp = 0.0
        self.state = 0.0
        self.mismatch = 0
        self.reward = 0.0
        self.worst: Dict[str, float] = {}

    def _note(self, name: str, value: float) -> None:
        self.worst[name] = max(self.worst.get(name, 0.0), value)

    def state_pair(self, program: Dict[str, torch.Tensor],
                   reference: Dict[str, torch.Tensor]) -> None:
        """The leaves of one state: the program's by name against the
        reference's (a leaf the program lacks counts its elements)."""
        for name, r in reference.items():
            p = program.get(name)
            if p is None or p.shape != r.shape:
                self.mismatch += r.numel()
                self._note(name, math.inf)
                continue
            if p.is_floating_point() or r.is_floating_point():
                gap = _gap(p, r)
                if name in KELVIN:
                    self.temp = max(self.temp, gap)
                    self._note(name, gap)
                else:
                    # A leaf's gap over its largest magnitude, in its own
                    # unit, or over 1 where that is smaller (a ramp of ~0 K).
                    value = gap / max(float(r.double().abs().max()) if r.numel() else 0.0, 1.0)
                    self.state = max(self.state, value)
                    self._note(name, value)
            else:
                n = int((p.to(torch.int64) != r.to(torch.int64).to(p.device)).sum())
                self.mismatch += n
                self._note(name, float(n))

    def rewards(self, program: torch.Tensor, reference: torch.Tensor) -> None:
        value = _rel(_gap(program, reference), float(reference.double().abs().max()))
        self.reward = max(self.reward, value)
        self._note("reward", value)

    def values(self) -> Dict[str, float]:
        return {"temp_gap_K": self.temp, "state_gap": self.state,
                "discrete_mismatch": float(self.mismatch), "reward_gap": self.reward}


def reference_leaves(ref: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The state leaves of a reference step (oracle.step.step)."""
    return {k: v for k, v in ref.items() if k not in ("temp", "reward", "iterations")}


def program_leaves(building, state) -> Dict[str, torch.Tensor]:
    """A program state's leaves under the reference's names: the field as
    each room's sorted values and the cells outside the rooms."""
    out = {k: v for k, v in leaves(state).items() if k not in NOT_COMPARED}
    out["temp.room_sorted"] = building.room_sorted(state.temp)
    out["temp.outside_rooms"] = building.outside_rooms(state.temp)
    return out


def gap_of_norms(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
                 keep: Sequence[str]) -> float:
    """The worst leaf of `keep`: |norm(program) - norm(reference)| over
    max(the leaf's reference norm, the median reference leaf norm)."""
    norms = {k: float(reference[k].double().norm()) for k in reference}
    median = sorted(norms.values())[len(norms) // 2] if norms else 0.0
    worst = 0.0
    for k in keep:
        p = float(program[k].double().norm())
        if not math.isfinite(p):
            return math.inf
        worst = max(worst, _rel(abs(p - norms[k]), max(norms[k], median)))
    return worst


def moved_leaves(grads: Dict[str, torch.Tensor], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient norm is at least `share` of the
    median leaf's: the others (such as a bias under a normalisation) move
    under Adam by round-off alone."""
    norms = {k: float(v.double().norm()) for k, v in grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return sorted(k for k, n in norms.items() if n >= share * median)


def comparisons(values: Dict[str, float], limits: Dict[str, float]) -> List[Tuple[str, float, float]]:
    """(name, value, limit) in the limits' order; a value that is not a
    finite number reads as the largest float, which fails every limit."""
    out = []
    for name, limit in limits.items():
        v = float(values[name])
        out.append((name, v if math.isfinite(v) else 1.7976931348623157e308, limit))
    return out
