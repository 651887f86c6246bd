"""Energy/carbon/comfort ("3C") regret reward over an env batch.

Implements the normalized regret function (reward in [-1, 0]) of
smart_control/reward/setpoint_energy_carbon_regret.py:93-291 on top of the
shared productivity/energy math of base_setpoint_energy_carbon_reward.py:
28-172.

Port of sbsim_tpu/envs/reward.py: the regret variant the env uses and the
unnormalized absolute variant (setpoint_energy_carbon_reward.py:84-190).
Per-zone inputs are (B, Z), per-env inputs (B,), parameters float32 0-d
tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from sbsim_tpu_torch import constants
from sbsim_tpu_torch.envs.config import RegretRewardConfig

_HOUR_SEC = 3600.0
# Natural-gas carbon intensity, kg CO2 per Joule
# (natural_gas_energy_cost.py:68-73).
GAS_CARBON_KG_PER_J = (
    constants.GAS_CO2 / constants.KWH_PER_KFT3_GAS / constants.JOULES_PER_KWH
)


@dataclasses.dataclass(frozen=True)
class RewardParams:
    max_productivity_personhour_usd: torch.Tensor
    min_productivity_personhour_usd: torch.Tensor
    max_electricity_rate: torch.Tensor
    max_natural_gas_rate: torch.Tensor
    productivity_midpoint_delta: torch.Tensor
    productivity_decay_stiffness: torch.Tensor
    productivity_weight: torch.Tensor
    energy_cost_weight: torch.Tensor
    carbon_emission_weight: torch.Tensor


def make_reward_params(config: RegretRewardConfig, device=None) -> RewardParams:
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return RewardParams(
        **{
            field.name: f(getattr(config, field.name))
            for field in dataclasses.fields(RewardParams)
        }
    )


@dataclasses.dataclass(frozen=True)
class RewardBreakdown:
    """Mirror of the informative RewardResponse fields
    (smart_control_reward.proto:123-195), each (B,)."""

    agent_reward_value: torch.Tensor
    productivity_reward: torch.Tensor
    electricity_energy_cost: torch.Tensor
    natural_gas_energy_cost: torch.Tensor
    carbon_emitted: torch.Tensor
    total_occupancy: torch.Tensor
    productivity_regret: torch.Tensor
    normalized_productivity_regret: torch.Tensor
    normalized_energy_cost: torch.Tensor
    normalized_carbon_emission: torch.Tensor


def zone_productivity(
    heating_setpoint: torch.Tensor,  # (B, 1)
    cooling_setpoint: torch.Tensor,  # (B, 1)
    zone_temp: torch.Tensor,  # (B, Z)
    occupancy: torch.Tensor,  # (B, Z)
    dt_sec: torch.Tensor,
    params: RewardParams,
) -> torch.Tensor:
    """Per-zone productivity in USD over the interval.

    Piecewise logistic decay outside the setpoint deadband
    (base_setpoint_energy_carbon_reward.py:78-123).
    """
    k = params.productivity_decay_stiffness
    x0_low = heating_setpoint - params.productivity_midpoint_delta
    x0_high = cooling_setpoint + params.productivity_midpoint_delta
    max_p = params.max_productivity_personhour_usd
    below = max_p / (1.0 + torch.exp(-k * (zone_temp - x0_low)))
    above = max_p * (1.0 - 1.0 / (1.0 + torch.exp(-k * (zone_temp - x0_high))))
    per_person_hour = torch.where(
        zone_temp < heating_setpoint,
        below,
        torch.where(zone_temp > cooling_setpoint, above, max_p),
    )
    return per_person_hour * occupancy * dt_sec / _HOUR_SEC


def compute_regret_reward(
    *,
    heating_setpoint: torch.Tensor,  # (B,)
    cooling_setpoint: torch.Tensor,  # (B,)
    zone_temps: torch.Tensor,  # (B, Z)
    zone_occupancy: torch.Tensor,  # (B, Z)
    electricity_energy_rate: torch.Tensor,  # (B,) W (blowers + |AC| + pumps)
    natural_gas_energy_rate: torch.Tensor,  # (B,) W
    elec_price: torch.Tensor,  # (B,) USD per W-second at this step
    elec_carbon: torch.Tensor,  # (B,) kg per W-second
    gas_price: torch.Tensor,  # (B,) USD per Joule
    dt_sec: torch.Tensor,
    params: RewardParams,
) -> RewardBreakdown:
    """Normalized 3C regret (setpoint_energy_carbon_regret.py:142-291)."""
    productivity = zone_productivity(
        heating_setpoint[:, None],
        cooling_setpoint[:, None],
        zone_temps,
        zone_occupancy,
        dt_sec,
        params,
    ).sum(dim=-1)
    total_occupancy = zone_occupancy.sum(dim=-1)

    max_productivity = (
        params.max_productivity_personhour_usd * total_occupancy * dt_sec / _HOUR_SEC
    )
    min_productivity = (
        params.min_productivity_personhour_usd * total_occupancy * dt_sec / _HOUR_SEC
    )
    actual_productivity = torch.maximum(productivity, min_productivity)
    normalized_productivity_regret = torch.where(
        total_occupancy > 0.0,
        (actual_productivity - min_productivity)
        / torch.clamp(max_productivity - min_productivity, min=1e-12)
        - 1.0,
        0.0,
    )

    capped_elec = torch.minimum(electricity_energy_rate, params.max_electricity_rate)
    elec_cost = elec_price * torch.abs(capped_elec) * dt_sec
    max_elec_cost = elec_price * params.max_electricity_rate * dt_sec
    elec_carbon_kg = elec_carbon * torch.abs(capped_elec) * dt_sec
    max_elec_carbon = elec_carbon * params.max_electricity_rate * dt_sec

    capped_gas = torch.minimum(natural_gas_energy_rate, params.max_natural_gas_rate)
    # Negative gas rates clamp to zero (natural_gas_energy_cost.py:92-96).
    gas_energy = torch.clamp(capped_gas, min=0.0) * dt_sec
    gas_cost = gas_price * gas_energy
    max_gas_cost = gas_price * params.max_natural_gas_rate * dt_sec
    gas_carbon_kg = GAS_CARBON_KG_PER_J * gas_energy
    max_gas_carbon = GAS_CARBON_KG_PER_J * params.max_natural_gas_rate * dt_sec

    normalized_energy_cost = (elec_cost + gas_cost) / (max_elec_cost + max_gas_cost)
    normalized_carbon = (elec_carbon_kg + gas_carbon_kg) / (
        max_elec_carbon + max_gas_carbon
    )

    raw = (
        normalized_productivity_regret * params.productivity_weight
        - normalized_energy_cost * params.energy_cost_weight
        - normalized_carbon * params.carbon_emission_weight
    )
    agent_reward = raw / (
        params.productivity_weight
        + params.energy_cost_weight
        + params.carbon_emission_weight
    )

    return RewardBreakdown(
        agent_reward_value=agent_reward,
        productivity_reward=actual_productivity,
        electricity_energy_cost=elec_cost,
        natural_gas_energy_cost=gas_cost,
        carbon_emitted=elec_carbon_kg + gas_carbon_kg,
        total_occupancy=total_occupancy,
        productivity_regret=actual_productivity - max_productivity,
        normalized_productivity_regret=normalized_productivity_regret,
        normalized_energy_cost=normalized_energy_cost,
        normalized_carbon_emission=normalized_carbon,
    )


def compute_absolute_reward(
    *,
    heating_setpoint: torch.Tensor,  # (B,)
    cooling_setpoint: torch.Tensor,  # (B,)
    zone_temps: torch.Tensor,  # (B, Z)
    zone_occupancy: torch.Tensor,  # (B, Z)
    electricity_energy_rate: torch.Tensor,  # (B,) W
    natural_gas_energy_rate: torch.Tensor,  # (B,) W
    elec_price: torch.Tensor,  # (B,) USD per W-second
    elec_carbon: torch.Tensor,  # (B,) kg per W-second
    gas_price: torch.Tensor,  # (B,) USD per Joule
    dt_sec: torch.Tensor,
    params: RewardParams,
    energy_cost_weight=1.0,
    carbon_cost_weight=1.0,
    carbon_cost_factor_usd_per_kg=0.0,
    reward_shift=0.0,
    reward_scale=1.0,
) -> RewardBreakdown:
    """Unnormalized variant: r = productivity - u*(costs) - w*carbon_cost,
    shifted/scaled (setpoint_energy_carbon_reward.py:84-190)."""
    productivity = zone_productivity(
        heating_setpoint[:, None],
        cooling_setpoint[:, None],
        zone_temps,
        zone_occupancy,
        dt_sec,
        params,
    ).sum(dim=-1)
    total_occupancy = zone_occupancy.sum(dim=-1)
    elec_cost = elec_price * torch.abs(electricity_energy_rate) * dt_sec
    elec_carbon_kg = elec_carbon * torch.abs(electricity_energy_rate) * dt_sec
    gas_energy = torch.clamp(natural_gas_energy_rate, min=0.0) * dt_sec
    gas_cost = gas_price * gas_energy
    gas_carbon_kg = GAS_CARBON_KG_PER_J * gas_energy
    carbon_cost = carbon_cost_factor_usd_per_kg * (elec_carbon_kg + gas_carbon_kg)
    raw = (
        productivity
        - energy_cost_weight * (elec_cost + gas_cost)
        - carbon_cost_weight * carbon_cost
    )
    agent_reward = (raw - reward_shift) * reward_scale
    max_productivity = (
        params.max_productivity_personhour_usd * total_occupancy * dt_sec / _HOUR_SEC
    )
    return RewardBreakdown(
        agent_reward_value=agent_reward,
        productivity_reward=productivity,
        electricity_energy_cost=elec_cost,
        natural_gas_energy_cost=gas_cost,
        carbon_emitted=elec_carbon_kg + gas_carbon_kg,
        total_occupancy=total_occupancy,
        productivity_regret=productivity - max_productivity,
        normalized_productivity_regret=torch.zeros_like(productivity),
        normalized_energy_cost=torch.zeros_like(productivity),
        normalized_carbon_emission=torch.zeros_like(productivity),
    )
