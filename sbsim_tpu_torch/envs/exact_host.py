"""Bit-faithful host mode: the reference control loop with its exact RNG.

Port of sbsim_tpu/envs/exact_host.py over the port's BuildingEnv (on any
device: the simulator reads the env's geometry, config and tables, which
are host numpy, and never its tensors). The device path
(envs/building_env.py) draws counter-based threefry / mix32 streams; this
slow host-mode simulator draws exactly what the reference draws: the
stochastic convection shuffle consumes a Python Mersenne-Twister stream as
stochastic_convection_simulator.py:62-145 does (a uniform per CV, a choice
per swap, a shuffle of the swap list, the candidate cache shared per
distance), and the occupancy model consumes a shared numpy RandomState as
randomized_arrival_departure_occupancy.py:104-218 does (occupants created
lazily in zone order, one draw per peek, two peeks per step).

Deterministic physics run through the numpy oracles
(physics/reference_impl.py), and all device math is float64 Python
arithmetic, as in the reference's scalar path. Numpy's promotion rules are
part of the result: sinusoid weather is a Python float, replay weather an
np.float64, device attributes Python floats and the recirculation mean an
np.float32 scalar.

Time runs on `datetime` without a tz database: local time comes from
scenario/tables.to_local, so the occupancy and schedule zones must be in
tables.TIME_ZONES (the constructor raises ValueError otherwise). The grid
layout comes from config.building.layout by the rule the env applies
(geometry.layout_transposed); the diffuser pattern is only checked against
it, never used to guess it.
"""

from __future__ import annotations

import dataclasses
import datetime
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sbsim_tpu_torch import constants
from sbsim_tpu_torch.core import floorplan as floorplan_lib
from sbsim_tpu_torch.core import geometry as geometry_lib
from sbsim_tpu_torch.physics import reference_impl
from sbsim_tpu_torch.scenario import tables as tables_lib
from sbsim_tpu_torch.scenario import uscalendar
from sbsim_tpu_torch.scenario import weather as weather_lib

CP_AIR = constants.AIR_HEAT_CAPACITY
CP_WATER = constants.WATER_HEAT_CAPACITY

MODE_OFF, MODE_HEAT, MODE_COOL, MODE_PASSIVE_COOL = 0, 1, 2, 3

_FIVE_MINUTES = datetime.timedelta(minutes=5)
# K: the largest |dT| a device trajectory may drift from the exact host
# (tests/test_device_vs_host.py).
DRIFT_BUDGET = 5e-2
# Steps a device trajectory may take to come back within the budget, modes
# equal, after a threshold crossing (ParityTracker).
RECOVERY_STEPS = 48
# K: how far the device's and the host's zone means may differ beyond the
# field drift they are taken from (their float32 sums run in other orders:
# a few ulps at 300 K).
ZONE_MEAN_SLACK = 1e-4


class _ExactOccupant:
    """One occupant's AWAY/WORK machine drawing from the shared stream
    (randomized_arrival_departure_occupancy.py:41-146)."""

    def __init__(self, cfg, time_step_sec: float, rs: np.random.RandomState):
        self._cfg = cfg
        self._rs = rs
        self.working = False

        def probability(start, end):
            window_steps = (end - start) * 3600.0 / time_step_sec
            return 1.0 / (window_steps / 2.0)

        self._p_arrival = probability(
            cfg.earliest_expected_arrival_hour,
            cfg.latest_expected_arrival_hour,
        )
        self._p_departure = probability(
            cfg.earliest_expected_departure_hour,
            cfg.latest_expected_departure_hour,
        )

    def peek(self, local_ts: datetime.datetime) -> bool:
        """`local_ts`: local wall-clock time (naive)."""
        cfg = self._cfg
        if not uscalendar.is_work_day(local_ts.date()):
            self.working = False
        elif not self.working:
            in_window = (
                cfg.earliest_expected_arrival_hour
                <= local_ts.hour
                <= cfg.latest_expected_arrival_hour
            )
            # The reference draws only inside the arrival window
            # (randomized_...occupancy.py:107-115).
            if in_window and self._rs.rand() < self._p_arrival:
                self.working = True
        else:
            if (
                local_ts.hour >= cfg.earliest_expected_departure_hour
                and self._rs.rand() < self._p_departure
            ):
                self.working = False
        return self.working


class ExactConvection:
    """Stochastic in-room shuffle with the reference's exact Python-random
    stream (stochastic_convection_simulator.py:35-145)."""

    def __init__(self, p: float, distance: int, seed: Optional[int],
                 room_lists: Sequence[List[Tuple[int, int]]]):
        self._p = p
        self._distance = distance
        self._rand = random.Random(seed) if seed is not None else random.Random()
        self._rooms = room_lists
        self._cache: Dict[int, Dict[Tuple[int, int], list]] = {}

    def apply(self, temp: np.ndarray) -> None:
        p, distance = self._p, self._distance
        if p == 0 or distance == 0:
            return
        for coords in self._rooms:
            if distance == -1 and p == 1:
                self._shuffle_whole_room(coords, temp)
            else:
                self._shuffle_max_dist(coords, temp)

    def _shuffle_whole_room(self, coords, temp) -> None:
        values = {cv: temp[cv] for cv in coords}
        order = list(coords)
        self._rand.shuffle(order)
        for src, dst in zip(coords, order):
            temp[dst] = values[src]

    def _shuffle_max_dist(self, coords, temp) -> None:
        max_dist = 1000 if self._distance == -1 else self._distance
        in_room = set(coords)
        cache = self._cache.setdefault(max_dist, {})
        swaps = []
        for cv in coords:
            if self._rand.uniform(0, 1) > self._p:
                continue
            candidates = cache.get(cv)
            if candidates is None:
                candidates = []
                # Asymmetric window and *squared*-distance bound, exactly as
                # the reference computes them (:125-134).
                for a in range(cv[0] - max_dist, cv[0] + max_dist):
                    for b in range(cv[1] - max_dist, cv[1] + max_dist):
                        other = (a, b)
                        if other not in in_room:
                            continue
                        if (cv[0] - a) ** 2 + (cv[1] - b) ** 2 <= max_dist:
                            candidates.append(other)
                cache[cv] = candidates
            swaps.append((cv, self._rand.choice(candidates)))
        self._rand.shuffle(swaps)
        for a, b in swaps:
            temp[a], temp[b] = temp[b], temp[a]


class ExactHostSimulator:
    """Single-building host simulator, reference-faithful step by step."""

    def __init__(self, env, naive_timestamps: bool = False, solver: Optional[str] = None):
        """Args:
        env: the configured BuildingEnv (for geometry/config/tables).
        naive_timestamps: treat simulation time as tz-naive, matching a
          reference configured with naive timestamps (its occupancy then
          skips timezone conversion, randomized_...occupancy.py:84-89).
        solver: "jacobi" replicates TFSimulator (the sb1 default,
          tf_simulator.py:573-853); "gauss_seidel" replicates the legacy
          scalar in-place sweep (simulator.py:98-316, the
          SimulatorFlexibleGeometries path). None follows the config's
          host_solver (which gin_compat sets from the simulator wiring the
          gin file selects, sim_config_legacy.gin:182).
        """
        self.env = env
        self.cfg = env.config
        self.geom = env.geom
        self._naive = naive_timestamps
        if solver is None:
            solver = self.cfg.host_solver
        if solver not in ("jacobi", "gauss_seidel"):
            raise ValueError(f"unknown solver: {solver}")
        self.solver = solver
        for kind, zone in (("occupancy", self.cfg.occupancy.time_zone),
                           ("schedule", self.cfg.schedule.time_zone)):
            if zone not in tables_lib.TIME_ZONES:
                raise ValueError(
                    f"{kind} time zone {zone!r} not supported; one of "
                    f"{sorted(tables_lib.TIME_ZONES)}")
        # The host path rebuilds float64 arrays (materials, diffusers,
        # in-building mask) from the raw floor plan, once; where the
        # geometry runs transposed (BuildingConfig.layout), the rebuilds are
        # transposed to match.
        self._processed = self._process_plan()
        raw_diffusers = self._rebuild_diffusers_raw()
        self._plan_transposed = raw_diffusers is not None and geometry_lib.layout_transposed(
            self.cfg.building.layout, raw_diffusers.shape)
        self._check_layout(raw_diffusers)
        self._scalar_materials = (
            self._materials64() if solver == "gauss_seidel" else None
        )
        self._present = self._present_mask() if solver == "gauss_seidel" else None
        self._replay_weather = None  # lazy ReplayWeather cache

        start = weather_lib.parse_timestamp(self.cfg.start_timestamp)
        if naive_timestamps:
            start = start.replace(tzinfo=None)
        self.start_timestamp = start
        self.time = start
        self.dt = datetime.timedelta(seconds=self.cfg.time_step_sec)

        zone_ids = np.asarray(self.geom.zone_ids)
        self.zone_masks = [
            np.argwhere(zone_ids == z) for z in range(self.geom.n_zones)
        ]
        # Float64 diffuser fractions, matching the reference's arrays
        # (geometry stores float32 for the device path).
        self._diffusers64 = (
            self._align(raw_diffusers) if raw_diffusers is not None
            else np.asarray(self.geom.diffusers, np.float64)
        )
        room_lists = [
            [tuple(c) for c in coords] for coords in self.zone_masks
        ]
        conv = self.cfg.convection
        self.convection = ExactConvection(
            conv.p, conv.distance, conv.seed, room_lists
        )
        self._occupancy_rs = np.random.RandomState(17321)
        self._zone_occupants: Dict[str, List[_ExactOccupant]] = {}

        self.reset()

    def _align(self, arr: np.ndarray) -> np.ndarray:
        """Brings a plan-orientation array into the geometry's layout."""
        if self._plan_transposed:
            return np.ascontiguousarray(arr.T)
        return arr

    def _process_plan(self) -> Optional[floorplan_lib.ProcessedFloorPlan]:
        b = self.cfg.building
        if b.kind == "floor_plan" and b.floor_plan is not None:
            return floorplan_lib.process_floor_plan(b.floor_plan, b.zone_map)
        return None

    def _rebuild_diffusers_raw(self) -> Optional[np.ndarray]:
        """Float64 diffusers in the raw plan orientation, or None when the
        config has no floor plan to rebuild from."""
        processed = self._processed
        if processed is None:
            return None
        return floorplan_lib.assign_thermal_diffusers(
            processed.floor_plan.shape,
            processed.room_dict,
            interior_walls=processed.interior_walls_initial,
            buffer_from_walls=self.cfg.building.buffer_from_walls,
        )

    def _check_layout(self, raw: Optional[np.ndarray]) -> None:
        """The rebuilt diffusers, in the layout the config names, must put a
        diffuser where the geometry does."""
        if raw is None:
            return
        aligned = self._align(raw)
        geom_pattern = np.asarray(self.geom.diffusers) > 0
        if aligned.shape != geom_pattern.shape or not np.array_equal(aligned > 0, geom_pattern):
            raise ValueError(
                "the floor plan's diffusers in layout "
                f"{self.cfg.building.layout!r} (transposed: {self._plan_transposed}) "
                "disagree with the geometry's; the env's geometry was not built "
                "from config.building.floor_plan"
            )

    def _materials64(self):
        """Float64 (conductivity, heat_capacity, density) grids rebuilt from
        the config materials (the geometry keeps float32 for the device
        path; the scalar sweep needs the float64 originals)."""
        processed = self._processed
        if processed is None:
            return None
        b = self.cfg.building

        def assign(prop):
            out = np.full(
                processed.floor_plan.shape,
                getattr(b.inside_air, prop),
                np.float64,
            )
            out[processed.exterior_walls] = getattr(b.building_exterior, prop)
            out[processed.interior_walls] = getattr(b.inside_wall, prop)
            return self._align(out)

        return (
            assign("conductivity"),
            assign("heat_capacity"),
            assign("density"),
        )

    def _present_mask(self) -> np.ndarray:
        """In-building mask for the scalar solver's neighbor lists
        (building.py:794-813 excludes outside-air CVs; the legacy
        rectangular building has no outside air at all)."""
        b = self.cfg.building
        if self._processed is not None:
            plan = floorplan_lib.guarantee_air_padding(b.floor_plan)
            return self._align(plan != constants.EXTERIOR_SPACE_VALUE)
        return np.ones(self.geom.shape, bool)

    # ------------------------------------------------------------------

    def reset(self) -> None:
        # Reference dtype flow: reset() fills float64
        # (building.py:784-792); the first FDM step replaces it with the
        # float32 solver output.
        self.temp = np.array(self.geom.reset_temps, np.float64)
        self.input_q = np.zeros(self.geom.shape, np.float64)
        self.time = self.start_timestamp
        n = self.geom.n_zones
        # Python-float device attributes, exactly as the reference keeps
        # them: numpy's weak promotion then rounds the VAV supply-temp
        # chain to float32 identically (vav.py:168-195 with NEP 50).
        self.damper = [0.1] * n
        self.reheat_valve = [0.0] * n
        self.mode = [MODE_OFF] * n
        self.zone_air_temp = [0.0] * n
        self.prev_comfort: Optional[bool] = None
        hv = self.cfg.hvac
        self.ahu_heating_setpoint = float(hv.ahu_heating_setpoint)
        self.ahu_cooling_setpoint = float(hv.ahu_cooling_setpoint)
        self.ahu_flow = 0.0
        self.cooling_request_count = 0
        self.boiler_setpoint = float(hv.boiler_setpoint)
        self.boiler_current_temp = float(hv.boiler_setpoint)
        self.boiler_return_water = 0.0
        self.boiler_flow = 0.0
        self.heating_request_count = 0
        self.boiler_tank_change = 0.0
        self.boiler_last_duration = 0.0
        self.boiler_has_action = False
        self._zone_occupants = {}
        # Reset observation (environment.py:1174): boiler sensor ramp init +
        # occupancy probe at start - 5 min.
        self._boiler_observe(0.0)
        self.num_occupants_obs = self._peek_all(self.time - _FIVE_MINUTES)

    # ------------------------------------------------------------------

    def _local(self, ts: datetime.datetime, time_zone: str) -> datetime.datetime:
        """Naive local wall-clock time; a naive timestamp is taken as it is
        (the reference skips the conversion for naive timestamps)."""
        if ts.tzinfo is None:
            return ts
        return tables_lib.to_local(ts, time_zone)

    def _peek_all(self, ts: datetime.datetime) -> float:
        """One peek of every occupant of every zone, zone order = raster
        (simulator_building.py:305-315 / simulator reward path)."""
        if self.cfg.occupancy.kind != "randomized":
            return 0.0
        local = self._local(ts, self.cfg.occupancy.time_zone)
        total = 0.0
        self._last_zone_occupancy = np.zeros(self.geom.n_zones)
        for z, ext_id in enumerate(self.geom.zone_ext_ids):
            occupants = self._zone_occupants.get(ext_id)
            if occupants is None:
                occupants = [
                    _ExactOccupant(
                        self.cfg.occupancy,
                        self.cfg.time_step_sec,
                        self._occupancy_rs,
                    )
                    for _ in range(self.cfg.occupancy.zone_assignment)
                ]
                self._zone_occupants[ext_id] = occupants
            count = sum(1.0 for occ in occupants if occ.peek(local))
            self._last_zone_occupancy[z] = count
            total += count
        return total

    def _schedule_window(self, ts: datetime.datetime) -> Tuple[bool, float, float]:
        sched = self.cfg.schedule
        # A naive timestamp is read as UTC (setpoint_schedule.py:100-106).
        local = self._local(ts, sched.time_zone)
        comfort = (
            sched.morning_start_hour <= local.hour < sched.evening_start_hour
            and local.timetuple().tm_yday not in set(sched.holidays)
            and local.weekday() < 5
        )
        window = (
            sched.comfort_temp_window if comfort else sched.eco_temp_window
        )
        return comfort, float(window[0]), float(window[1])

    def _weather(self, ts: datetime.datetime):
        w = self.cfg.weather
        if w.kind == "sinusoid":
            # Python float, exactly like WeatherController.get_current_temp's
            # math.sin pipeline: a weak scalar under NumPy 2 promotion.
            return weather_lib.sinusoid_temperature(
                ts, w.low_temp, w.high_temp, w.special_days
            )
        if self._replay_weather is None:
            self._replay_weather = weather_lib.ReplayWeather(
                w.replay_csv_path
            )
        # np.float64, exactly like ReplayWeatherController.get_current_temp's
        # np.interp scalar: a strong scalar, so the mixed-air blend with the
        # float32 recirculation mean promotes to float64 here but stays
        # float32 under the sinusoid's Python float. Wrapping this in
        # float() would round the supply-air temp to f32 and break bitwise
        # parity.
        return self._replay_weather.temperatures([ts])[0]

    def _zone_average_temps(self) -> np.ndarray:
        return np.array(
            [
                np.mean([self.temp[tuple(c)] for c in coords])
                for coords in self.zone_masks
            ]
        )

    def _boiler_observe(self, duration_sec: float) -> None:
        """Lazy supply-temp ramp on observation (boiler.py:158-217)."""
        if self.boiler_has_action:
            dur = duration_sec
        else:
            dur = self.boiler_last_duration
            self.boiler_has_action = True
        hv = self.cfg.hvac
        if hv.boiler_heating_rate > 0.0 and hv.boiler_cooling_rate > 0.0:
            begin = self.boiler_current_temp
            target = self.boiler_setpoint
            if target > begin:
                new = min(begin + hv.boiler_heating_rate * dur / 60.0, target)
            elif target < begin:
                new = max(begin - hv.boiler_cooling_rate * dur / 60.0, target)
            else:
                new = target
            self.boiler_current_temp = new
            self.boiler_tank_change = new - begin
        else:
            self.boiler_current_temp = self.boiler_setpoint
        self.boiler_last_duration = dur

    # ------------------------------------------------------------------

    def step(self, setpoints: Dict[str, float]) -> Dict[str, float]:
        """One control step with native-unit agent setpoints.

        Mirrors environment.py:1228-1360: request_action (thermostat default
        control, then agent setpoints), wait_time (physics), observation and
        reward at the new timestamp. Returns reward components.
        """
        cfg = self.cfg
        hv = cfg.hvac

        # ---- request_action: setup_step_sim (simulator.py:383-396) -------
        zone_temps = self._zone_average_temps()
        comfort, heat_sp, cool_sp = self._schedule_window(self.time)
        mid = 0.5 * (cool_sp - heat_sp) + heat_sp
        for z in range(self.geom.n_zones):
            t = zone_temps[z]
            mode = self.mode[z]
            # thermostat.py:76-148
            if t < heat_sp:
                default = MODE_HEAT
            elif t > cool_sp:
                default = MODE_COOL
            elif t < mid and mode == MODE_HEAT:
                default = MODE_HEAT
            elif t > mid and mode == MODE_COOL:
                default = MODE_COOL
            else:
                default = MODE_OFF
            if comfort:
                new_mode = default
            elif self.prev_comfort is not None and self.prev_comfort:
                new_mode = MODE_PASSIVE_COOL
            elif mode == MODE_PASSIVE_COOL and t > heat_sp:
                new_mode = MODE_PASSIVE_COOL
            else:
                new_mode = default
            self.mode[z] = new_mode
            if new_mode in (MODE_HEAT, MODE_COOL):
                self.damper[z] = 1.0
                self.reheat_valve[z] = 1.0 if new_mode == MODE_HEAT else 0.0
            else:
                self.damper[z] = 0.1
                self.reheat_valve[z] = 0.0
            self.zone_air_temp[z] = t
        self.prev_comfort = comfort
        # The thresholds this step's thermostat decisions compared with.
        self.thermostat_thresholds = (heat_sp, cool_sp, mid)

        # Agent setpoints (simulator_building.py:204-263).
        if "supply_water_setpoint" in setpoints:
            self.boiler_setpoint = float(setpoints["supply_water_setpoint"])
            self.boiler_has_action = True
        if "supply_air_heating_temperature_setpoint" in setpoints:
            self.ahu_heating_setpoint = float(
                setpoints["supply_air_heating_temperature_setpoint"]
            )
        if "supply_air_cooling_temperature_setpoint" in setpoints:
            self.ahu_cooling_setpoint = float(
                setpoints["supply_air_cooling_temperature_setpoint"]
            )

        # ---- wait_time: execute_step_sim (simulator_flexible_floor_plan
        # .py:124-190) --------------------------------------------------
        ambient = self._weather(self.time)
        h_conv = cfg.weather.convection_coefficient
        recirculation = self.temp.mean()  # np.float32 scalar, reference promotion
        mixed = (
            hv.ahu_recirculation * recirculation
            + (1.0 - hv.ahu_recirculation) * ambient
        )
        supply_air = min(
            max(mixed, self.ahu_heating_setpoint), self.ahu_cooling_setpoint
        )

        if self.solver == "jacobi":
            new_temp, _, _ = reference_impl.tf_finite_differences_timestep(
                self.geom,
                self.temp,
                self.input_q,
                ambient,
                h_conv,
                cfg.time_step_sec,
                cfg.convergence_threshold,
                cfg.iteration_limit,
            )
        else:
            new_temp, _, _ = reference_impl.scalar_finite_differences_timestep(
                self.geom,
                self.temp,
                self.input_q,
                ambient,
                h_conv,
                cfg.time_step_sec,
                cfg.convergence_threshold,
                cfg.iteration_limit,
                present=self._present,
                materials64=self._scalar_materials,
            )
        # Keep the solver's dtype, exactly as the reference leaves
        # building.temp (float32 for TFSimulator, tf_simulator.py:853;
        # float64 for the scalar sweep): subsequent means/sensor reads then
        # round identically to the reference.
        self.temp = new_temp
        self.convection.apply(self.temp)

        self.ahu_flow = 0.0
        self.cooling_request_count = 0
        self.boiler_flow = 0.0
        self.heating_request_count = 0
        numerator = 0.0
        denominator = 0.0
        for z in range(self.geom.n_zones):
            damper, valve = self.damper[z], self.reheat_valve[z]
            air_flow = damper * hv.vav_max_air_flow_rate
            reheat_flow = valve * hv.vav_reheat_max_water_flow_rate
            heat_diff = CP_AIR * air_flow - CP_WATER * reheat_flow
            zone_supply = (
                supply_air * heat_diff
                + self.boiler_setpoint * CP_WATER * reheat_flow
            ) / air_flow / CP_AIR
            q_zone = (
                air_flow * CP_AIR * (zone_supply - zone_temps[z])
                if air_flow > 0
                else 0.0
            )
            if air_flow > 0:
                self.ahu_flow = min(
                    self.ahu_flow + air_flow, hv.ahu_max_air_flow_rate
                )
                self.cooling_request_count += 1
            if reheat_flow > 0:
                self.boiler_flow += reheat_flow
                self.heating_request_count += 1
            numerator += valve * zone_supply
            denominator += valve
            for c in self.zone_masks[z]:
                cv = tuple(c)
                if self._diffusers64[cv] > 0.0:
                    self.input_q[cv] = q_zone * self._diffusers64[cv]
        self.boiler_return_water = numerator / (denominator + 1e-6)
        self.time = self.time + self.dt

        # ---- observation at t+1 ------------------------------------------
        self.num_occupants_obs = self._peek_all(self.time - _FIVE_MINUTES)
        self._boiler_observe(cfg.time_step_sec)

        # ---- reward at t+1 -----------------------------------------------
        self._peek_all(self.time)
        zone_occupancy = (
            self._last_zone_occupancy
            if cfg.occupancy.kind == "randomized"
            else np.zeros(self.geom.n_zones)
        )
        post_zone_temps = self._zone_average_temps()
        ambient_next = self._weather(self.time)
        recirculation_next = self.temp.mean()
        mixed_next = (
            hv.ahu_recirculation * recirculation_next
            + (1.0 - hv.ahu_recirculation) * ambient_next
        )
        supply_next = min(
            max(mixed_next, self.ahu_heating_setpoint),
            self.ahu_cooling_setpoint,
        )
        blower = (
            self.ahu_flow
            * hv.ahu_fan_differential_pressure
            / hv.ahu_fan_efficiency
            * (1.0 + (1.0 - hv.ahu_recirculation))
        )
        ac = self.ahu_flow * CP_AIR * (supply_next - mixed_next)
        pump = (
            self.boiler_flow
            * constants.WATER_DENSITY
            * constants.GRAVITY
            * hv.boiler_pump_differential_head
            / hv.boiler_pump_efficiency
        )
        supply_water = max(self.boiler_setpoint, self.boiler_return_water)
        flow_heating = CP_WATER * self.boiler_flow * (
            supply_water - self.boiler_return_water
        )
        r1 = 0.5
        r2 = r1 + 0.06
        dissipation = (2.0 * np.pi * 2.0 * (supply_water - ambient_next)) / (
            np.log(r2 / r1) / 0.067 + 1.0 / (5.6 * r2)
        )
        tank = (
            CP_WATER * 1.5 * self.boiler_tank_change / self.boiler_last_duration
            if self.boiler_last_duration > 0
            else 0.0
        )
        return {
            "zone_temps": post_zone_temps,
            "zone_occupancy": zone_occupancy,
            "num_occupants_obs": self.num_occupants_obs,
            "electricity_rate": blower + abs(ac) + pump,
            "gas_rate": flow_heating + dissipation + tank,
            "supply_water_temperature": self.boiler_current_temp,
        }


class ParityError(AssertionError):
    """A device trajectory left its exact host."""


@dataclasses.dataclass
class ParityReport:
    """What a ParityTracker saw: the steps held, the largest drift outside
    recovery windows and its step, the last step's drift, each threshold
    crossing as (step, zones, margin) and each recovery window as (first
    step, last step)."""

    steps: int = 0
    max_drift: float = 0.0
    max_drift_step: int = -1
    last_drift: float = 0.0
    crossings: List[Tuple[int, Tuple[int, ...], float]] = dataclasses.field(default_factory=list)
    windows: List[Tuple[int, int]] = dataclasses.field(default_factory=list)


class ParityTracker:
    """Holds a device trajectory to an ExactHostSimulator, step by step.

    Every step: max |dT| under `budget` and every thermostat mode equal
    (the gate of tests/test_device_vs_host.py), with one exception. The two
    trajectories round differently in float32 (the device path has no FMA
    contraction), and their fields drift apart by a few mK over a day. When
    a zone's temperature sits at a thermostat threshold, that drift can put
    the device and the host on opposite sides of it: a threshold crossing.
    A mode mismatch is taken as one only where, for every zone that
    differs, the device's and the host's pre-step zone temperatures lie on
    opposite sides of one of the step's thresholds (heating setpoint,
    cooling setpoint, their midpoint) and differ by no more than the field
    drift of the step before (plus ZONE_MEAN_SLACK). The crossing opens a
    recovery window, which must close (modes equal and the field within
    the budget again) within `recovery_steps`, and must have closed by
    the run's end (`finish`); any other mismatch, or drift outside a
    window, raises ParityError.
    """

    def __init__(self, budget: float = DRIFT_BUDGET, recovery_steps: int = RECOVERY_STEPS):
        self.budget = budget
        self.recovery_steps = recovery_steps
        self.report = ParityReport()
        self._window_start: Optional[int] = None
        self._last_drift = 0.0

    def check(self, step: int, temp: np.ndarray, modes: Sequence[int],
              zone_air_temp: Sequence[float], host: ExactHostSimulator) -> float:
        """Holds one step: the device's field, thermostat modes and pre-step
        zone temperatures after `step` against `host` after the same step.
        Returns the step's max |dT|."""
        report = self.report
        report.steps += 1
        drift = float(np.max(np.abs(np.asarray(temp, np.float64) - host.temp)))
        margin, self._last_drift = self._last_drift + ZONE_MEAN_SLACK, drift
        report.last_drift = drift
        modes = [int(m) for m in modes]
        agree = modes == host.mode and drift < self.budget
        if self._window_start is not None:
            if agree:
                report.windows.append((self._window_start, step - 1))
                self._window_start = None
            elif step - self._window_start >= self.recovery_steps:
                raise ParityError(
                    f"step {step}: not back within {self.budget} K with modes equal "
                    f"{self.recovery_steps} steps after the crossing at step "
                    f"{self._window_start} (drift {drift})")
            else:
                return drift
        if agree:
            if drift > report.max_drift:
                report.max_drift, report.max_drift_step = drift, step
            return drift
        zones = [z for z, (a, b) in enumerate(zip(modes, host.mode)) if a != b]
        if not zones or not all(self._crossed(zone_air_temp[z], host.zone_air_temp[z],
                                              host.thermostat_thresholds, margin)
                                for z in zones):
            raise ParityError(
                f"step {step}: drift {drift} K (budget {self.budget}); modes "
                f"{modes} against the host's {host.mode}")
        report.crossings.append((step, tuple(zones), margin))
        self._window_start = step
        return drift

    def finish(self, allow_crossings: bool = True) -> ParityReport:
        """Ends the run and returns the report. Raises ParityError if a
        recovery window is still open (the last step was not back within
        the budget with modes equal) or, without `allow_crossings`, if any
        threshold crossing was seen."""
        report = self.report
        if self._window_start is not None:
            raise ParityError(
                f"the run ended at step {report.steps - 1} inside the recovery window of the "
                f"crossing at step {self._window_start} (last drift {report.last_drift} K)")
        if report.crossings and not allow_crossings:
            raise ParityError(f"threshold crossings where none is allowed: {report.crossings}")
        return report

    @staticmethod
    def _crossed(device_t: float, host_t: float, thresholds, margin: float) -> bool:
        device_t, host_t = float(device_t), float(host_t)
        return abs(device_t - host_t) <= margin and any(
            (device_t - th) * (host_t - th) <= 0.0 for th in thresholds)
