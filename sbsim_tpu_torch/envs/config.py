"""Environment configuration dataclasses.

Plain-Python, host-side configs playing the role of the reference's gin
wiring (configs/resources/sb1/sim_config.gin). Presets mirroring the released
sb1 calibration constants live in envs/presets.py. A copy of
sbsim_tpu/envs/config.py: the fields and defaults are the same, so a config
means the same building in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np

from sbsim_tpu_torch.core.geometry import MaterialProperties

# Public tariff/carbon tables carried by the reference
# (smart_control/reward/electricity_energy_cost.py:39-123 — PG&E TOU rates and
# a carbon-intensity-by-hour profile; natural_gas_energy_cost.py:31-44 — EIA
# California monthly gas prices, 2020).
CARBON_EMISSION_BY_HOUR_KG_PER_MWH: Tuple[float, ...] = (
    88.19666493, 87.79190866, 87.87607686, 87.83054163, 88.00279618,
    88.19648183, 89.70663283, 93.97947901, 98.85868291, 100.7853521,
    101.3866866, 101.7795612, 102.5919168, 103.4403736, 104.1380294,
    104.7359292, 102.0714466, 97.04226176, 93.57895651, 92.46355045,
    91.72914657, 90.69209747, 89.76552213, 88.99950995,
)
WEEKDAY_PRICE_BY_HOUR_CENTS_PER_KWH: Tuple[float, ...] = (
    16.0, 16.0, 16.0, 16.0, 16.0, 16.0, 18.0, 18.0, 18.0, 18.0, 18.0, 18.0,
    20.0, 20.0, 20.0, 20.0, 20.0, 20.0, 20.0, 16.0, 16.0, 16.0, 16.0, 16.0,
)
WEEKEND_PRICE_BY_HOUR_CENTS_PER_KWH: Tuple[float, ...] = (16.0,) * 24
GAS_PRICE_BY_MONTH_USD_PER_KFT3: Tuple[float, ...] = (
    9.02, 8.35, 7.77, 7.26, 6.69, 6.86, 6.77, 6.76, 6.99, 7.19, 7.96, 8.98,
)


@dataclasses.dataclass(frozen=True)
class WeatherConfig:
    """Sinusoidal or replay weather (weather_controller.py:47-218)."""

    kind: str = "sinusoid"  # "sinusoid" | "replay"
    low_temp: float = 273.0
    high_temp: float = 283.0
    special_days: Mapping[int, Tuple[float, float]] = dataclasses.field(
        default_factory=dict
    )
    convection_coefficient: float = 12.0
    replay_csv_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Comfort/eco setpoint schedule (setpoint_schedule.py:29-128)."""

    morning_start_hour: int = 6
    evening_start_hour: int = 19
    comfort_temp_window: Tuple[float, float] = (294.0, 297.0)
    eco_temp_window: Tuple[float, float] = (289.0, 298.0)
    holidays: Tuple[int, ...] = ()  # day-of-year (1-365), local time
    time_zone: str = "US/Pacific"


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    """Randomized arrival/departure or deterministic step-function occupancy
    (randomized_arrival_departure_occupancy.py:36-218,
    step_function_occupancy.py:37-173)."""

    kind: str = "randomized"  # "randomized" | "step_function"
    zone_assignment: int = 1  # occupants per zone
    earliest_expected_arrival_hour: int = 7
    latest_expected_arrival_hour: int = 12
    earliest_expected_departure_hour: int = 13
    latest_expected_departure_hour: int = 18
    time_zone: str = "US/Pacific"
    # step-function parameters
    work_occupancy: float = 1.0
    nonwork_occupancy: float = 0.1
    work_start_hour: int = 9
    work_end_hour: int = 17


@dataclasses.dataclass(frozen=True)
class ConvectionConfig:
    """Stochastic in-room shuffling (stochastic_convection_simulator.py:35).

    method "swap" (default) mixes via rounds of masked pair swaps on the
    grid - the reference's own pairwise-swap primitive, gather-free on
    device; "argsort" draws a uniform random permutation per room tile.
    rounds=0 auto-sizes so expected swap participations per CV match the
    reference (~2p per step).
    """

    p: float = 0.0
    distance: int = 0
    seed: int = 5
    method: str = "swap"
    rounds: int = 0
    variants: int = 0
    # PRNG for the per-round swap decisions: "mix32" (default) expands the
    # per-env step key to per-cell Bernoulli bits with a murmur3-finalizer
    # counter hash; "threefry" draws them with threefry (rng.bits), and the
    # kernels then read the precomputed (B, H, W) word plane.
    rng: str = "mix32"
    # Explicit swap-round schedule: a tuple of (dy, dx, phase) triples,
    # applied in order (overrides seed/rounds selection entirely). Offsets
    # must respect the distance bound;
    # phases are the lead-parity alternation (physics/convection._lead_mask).
    schedule: Optional[Tuple[Tuple[int, int, int], ...]] = None


@dataclasses.dataclass(frozen=True)
class HvacConfig:
    vav_max_air_flow_rate: float = 0.035
    vav_reheat_max_water_flow_rate: float = 0.03
    ahu_recirculation: float = 0.3
    ahu_heating_setpoint: float = 285.0
    ahu_cooling_setpoint: float = 298.0
    ahu_fan_differential_pressure: float = 10000.0
    ahu_fan_efficiency: float = 0.9
    ahu_max_air_flow_rate: float = 8.67
    ahu_observes_outside_air: bool = True
    boiler_setpoint: float = 360.0
    boiler_pump_differential_head: float = 6.0
    boiler_pump_efficiency: float = 0.98
    boiler_heating_rate: float = 0.5  # K/min
    boiler_cooling_rate: float = 0.1  # K/min


@dataclasses.dataclass(frozen=True)
class RegretRewardConfig:
    """3C normalized regret (setpoint_energy_carbon_regret.py:93-291)."""

    max_productivity_personhour_usd: float = 300.0
    min_productivity_personhour_usd: float = 100.0
    max_electricity_rate: float = 160000.0
    max_natural_gas_rate: float = 400000.0
    productivity_midpoint_delta: float = 0.5
    productivity_decay_stiffness: float = 4.3
    productivity_weight: float = 0.2
    energy_cost_weight: float = 0.4
    carbon_emission_weight: float = 0.4
    weekday_electricity_prices: Tuple[float, ...] = (
        WEEKDAY_PRICE_BY_HOUR_CENTS_PER_KWH
    )
    weekend_electricity_prices: Tuple[float, ...] = (
        WEEKEND_PRICE_BY_HOUR_CENTS_PER_KWH
    )
    carbon_emission_rates: Tuple[float, ...] = CARBON_EMISSION_BY_HOUR_KG_PER_MWH
    gas_prices_by_month: Tuple[float, ...] = GAS_PRICE_BY_MONTH_USD_PER_KFT3


@dataclasses.dataclass(frozen=True)
class BuildingConfig:
    """Floor-plan or rectangular building."""

    kind: str = "floor_plan"  # "floor_plan" | "rectangular"
    cv_size_cm: float = 10.0
    floor_height_cm: float = 300.0
    initial_temp: float = 294.0
    inside_air: MaterialProperties = MaterialProperties(50.0, 700.0, 1.0)
    inside_wall: MaterialProperties = MaterialProperties(50.0, 700.0, 1.0)
    building_exterior: MaterialProperties = MaterialProperties(0.05, 700.0, 1.0)
    floor_plan: Optional[np.ndarray] = None
    floor_plan_path: Optional[str] = None
    zone_map: Optional[np.ndarray] = None
    buffer_from_walls: int = 3
    reset_temps: Optional[np.ndarray] = None
    # Grid-axis layout: "ref" keeps the floor plan's orientation; "transposed"
    # swaps the axes; "auto" transposes when geometry.padded_grid_cost
    # shrinks (the same rule as the JAX package, so both packages build the
    # same grid). Zone labels/order are unchanged; trajectories are
    # statistically identical but not bitwise (the 4-term stencil sum
    # rounds in a different order).
    layout: str = "ref"
    # rectangular variant
    room_shape: Tuple[int, int] = (8, 6)
    building_shape: Tuple[int, int] = (2, 1)


@dataclasses.dataclass(frozen=True)
class ActionNormalizerConfig:
    """Linear [-1,1] <-> native bounds (bounded_action_normalizer.py:28-126)."""

    min_native_value: float
    max_native_value: float
    min_normalized_value: float = -1.0
    max_normalized_value: float = 1.0


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    building: BuildingConfig = BuildingConfig()
    hvac: HvacConfig = HvacConfig()
    weather: WeatherConfig = WeatherConfig()
    schedule: ScheduleConfig = ScheduleConfig()
    occupancy: OccupancyConfig = OccupancyConfig()
    convection: ConvectionConfig = ConvectionConfig()
    reward: RegretRewardConfig = RegretRewardConfig()

    start_timestamp: str = "2023-07-06 07:00:00+00:00"
    time_step_sec: float = 300.0
    convergence_threshold: float = 0.1
    iteration_limit: int = 100
    # "jacobi" reproduces the reference solver semantics exactly;
    # "chebyshev" accelerates to the same fixed point (same residual
    # criterion) in ~2x fewer iterations - solutions agree within the
    # convergence threshold, iterate paths differ. Use for throughput.
    fdm_solver: str = "jacobi"
    # Which reference simulator wiring the HOST/exact path replicates:
    # "jacobi" = TFSimulator (sim_config.gin:168, f32 whole-grid Jacobi);
    # "gauss_seidel" = SimulatorFlexibleGeometries
    # (sim_config_legacy.gin:182, f64 scalar in-place sweep,
    # simulator.py:98-316). Consumed by envs/exact_host.ExactHostSimulator
    # when its solver arg is left as None; the device path always follows
    # the TFSimulator (Jacobi fixed-point) semantics.
    host_solver: str = "jacobi"
    # Chebyshev sub-iterations per residual check: >1 samples the residual
    # only every N sub-iterations, at the cost of at most (N-1) extra
    # sub-iterations (the solve only gets more converged). Jacobi paths
    # always check every iteration (reference stopping-rule semantics).
    cheby_check_every: int = 1
    # Envs per program of the JAX package's Pallas kernels. Under "stack"
    # a value > 1 runs the CUDA block kernels, at each body's measured best
    # of one env per thread block (fdm_cuda.route); "interleave" runs one
    # env per thread block whatever its value.
    pallas_block_envs: int = 1
    # "stack" | "interleave" (the JAX package's Pallas block layouts).
    pallas_block_mode: str = "stack"
    # Zone-count ceiling for kernel-emitted statistics (the JAX package's
    # rule, fdm_cuda.route); above it the gridstats fold after the
    # solve (bitwise-identical sums either way).
    kernel_stats_max_zones: int = 12
    num_days_in_episode: int = 14
    discount_factor: float = 0.9
    time_zone: str = "US/Pacific"

    # Action space: setpoint_name -> normalizer (sim_config.gin:228-244).
    action_normalizers: Mapping[str, ActionNormalizerConfig] = (
        dataclasses.field(
            default_factory=lambda: {
                "supply_water_setpoint": ActionNormalizerConfig(310.0, 355.0),
                "supply_air_heating_temperature_setpoint": (
                    ActionNormalizerConfig(285.0, 300.0)
                ),
            }
        )
    )

    # Explicit (device_id, setpoint_name) action tuples, the analogue of the
    # reference's device_action_tuples (environment.py:591-707). device_id is
    # "boiler", "air_handler", or "vav_<zone_name>" (per-zone damper/reheat
    # control). None keeps the sb1 default: the boiler + air-handler
    # setpoints above, in reference device order
    # (simulator_building.py:70-81). Every named field must have an entry in
    # action_normalizers.
    action_tuples: Optional[Tuple[Tuple[str, str], ...]] = None

    # Observation z-score constants: field id -> (mean, variance)
    # (sim_config.gin:252-583; fields absent here normalize to 0, matching
    # observation_normalizer.py:100-140).
    observation_normalization: Mapping[str, Tuple[float, float]] = (
        dataclasses.field(default_factory=dict)
    )

    # Histogram reduction: measurement_name -> bin edges
    # (sim_config.gin:586-590); empty disables the reducer.
    histogram_parameters: Mapping[str, Tuple[float, ...]] = dataclasses.field(
        default_factory=dict
    )

    num_hod_features: int = 1
    num_dow_features: int = 1
    occupancy_normalization_constant: float = 0.0

    # Episode-window randomization (beyond the reference, which always
    # replays the same fixed window - simulator.py reset semantics): with
    # episode_windows > 1, each reset samples one of N windows offset by
    # window_stride_hours from start_timestamp, so training sees varied
    # weather/calendar conditions.
    episode_windows: int = 1
    window_stride_hours: float = 24.0

    @property
    def steps_per_episode(self) -> int:
        return int(self.num_days_in_episode * 24 * 3600 / self.time_step_sec)
