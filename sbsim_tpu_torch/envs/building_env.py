"""The batched smart-building RL environment.

One env step reproduces the reference control loop
(environment.py:1228-1360 -> simulator_building.py:204-268 ->
simulator_flexible_floor_plan.py:124-190):

  1. request_action: default thermostat control from *pre-step* zone temps
     (setup_step_sim, simulator.py:383-396), then agent setpoints applied.
  2. wait_time: FDM solve, stochastic convection, VAV outputs computed from
     the pre-step zone temps (one-step actuation delay, simulator.py:578-592),
     demand accumulation, boiler return-water temperature, clock advance.
  3. observation at the new timestamp (boiler supply-temp ramp happens here,
     boiler.py:158-217).
  4. reward at the new timestamp via the 3C regret function.

Port of sbsim_tpu/envs/building_env.py. The state is a dataclass of tensors
with a leading env-batch dimension B (the JAX package's vmap written out),
keys are (B, 2) int64 tensors of uint32 values drawn with the port's
threefry (bitwise equal to jax.random), and every tensor lives on the env's
`device`: "cuda" unless the caller asks for the CPU.

The FDM solve of `step_batched` is one batched call: the hand-written CUDA
kernels (physics/fdm_cuda.py) for the "pallas_*" solver names, through the
env's route for that solver (`route`: fdm_cuda.route decides the kernel,
its block layout, the fused convection and where the statistics come
from, from the config's values), the plain batched solvers
(physics/fdm.py) for "xla_*". Swap convection runs in the kernel;
argsort convection runs after the solve. Zone/grid statistics come from
the kernel's epilogue where the route takes them from it, else from the
gridstats fold after the solve; the sums are bitwise the same either way.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sbsim_tpu_torch import graphs
from sbsim_tpu_torch import rng as rng_lib
from sbsim_tpu_torch.core import geometry as geometry_lib
from sbsim_tpu_torch.core.geometry import BuildingGeometry
from sbsim_tpu_torch.envs import observation as obs_lib
from sbsim_tpu_torch.envs import reward as reward_lib
from sbsim_tpu_torch.envs.config import EnvConfig
from sbsim_tpu_torch.hvac import devices as hvac_ops
from sbsim_tpu_torch.hvac.params import HvacState, initial_hvac_state, make_hvac_params
from sbsim_tpu_torch.physics import convection as convection_lib
from sbsim_tpu_torch.physics import fdm
from sbsim_tpu_torch.physics import fdm_cuda
from sbsim_tpu_torch.physics import gridstats
from sbsim_tpu_torch.scenario import occupancy as occupancy_lib
from sbsim_tpu_torch.scenario import tables as tables_lib
from sbsim_tpu_torch.utils import profiling

# FDM paths step_batched can run; "auto"/None resolves via resolve_solver.
_SOLVERS = (
    "pallas_env",
    "pallas_cheby",
    "xla_jacobi",
    "xla_chebyshev",
)


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Complete state of a batch of B building instances."""

    temp: torch.Tensor  # f32 (B, H, W)
    input_q: torch.Tensor  # f32 (B, H, W)
    zone_means: torch.Tensor  # f32 (B, Z) statistics of `temp`
    grid_mean: torch.Tensor  # f32 (B,) AHU recirculation temp
    hvac: HvacState
    occupants: torch.Tensor  # bool (B, Z, N)
    step_idx: torch.Tensor  # i32 (B,) completed steps
    window: torch.Tensor  # i32 (B,) episode-window index (0 unless episode_windows > 1)
    rng: torch.Tensor  # i64 (B, 2) uint32 threefry keys
    fdm_converged: torch.Tensor  # bool (B,), last step
    fdm_iterations: torch.Tensor  # i32 (B,), last step

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class StepOutput:
    observation: torch.Tensor  # f32 (B, obs_dim)
    reward: torch.Tensor  # f32 (B,)
    done: torch.Tensor  # bool (B,)
    reward_breakdown: reward_lib.RewardBreakdown
    # i32 (B,): each env's cluster barriers in the step's FDM solve, where
    # the kernels ran it on a plan that spans thread blocks; else None.
    fdm_barriers: Optional[torch.Tensor] = None


def resolve_device(device=None) -> torch.device:
    """The env's device: "cuda" unless the caller names another. Raises when
    CUDA is asked for (or implied) and no card is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "BuildingEnv runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device


class BuildingEnv:
    """Host-side wrapper holding the static pieces on one device; `reset`
    and `step_batched` act on a whole env batch."""

    def __init__(
        self,
        config: EnvConfig,
        geom: Optional[BuildingGeometry] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        dev = self.device
        self.config = config
        self.geom = geom if geom is not None else build_geometry(config)
        self.coeffs = fdm.stencil_coefficients(
            self.geom, config.time_step_sec, device=dev
        )
        if config.fdm_solver not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown fdm_solver: {config.fdm_solver}")
        self._spectral_radius = fdm.estimate_spectral_radius(
            self.coeffs, config.weather.convection_coefficient
        )
        h = config.hvac
        self.hvac_params = make_hvac_params(
            self.geom.n_zones,
            vav_max_air_flow_rate=h.vav_max_air_flow_rate,
            vav_reheat_max_water_flow_rate=h.vav_reheat_max_water_flow_rate,
            ahu_recirculation=h.ahu_recirculation,
            ahu_heating_setpoint=h.ahu_heating_setpoint,
            ahu_cooling_setpoint=h.ahu_cooling_setpoint,
            ahu_fan_differential_pressure=h.ahu_fan_differential_pressure,
            ahu_fan_efficiency=h.ahu_fan_efficiency,
            ahu_max_air_flow_rate=h.ahu_max_air_flow_rate,
            boiler_setpoint=h.boiler_setpoint,
            boiler_pump_differential_head=h.boiler_pump_differential_head,
            boiler_pump_efficiency=h.boiler_pump_efficiency,
            boiler_heating_rate=h.boiler_heating_rate,
            boiler_cooling_rate=h.boiler_cooling_rate,
            device=dev,
        )
        self.tables = tables_lib.build_episode_tables(config)
        # Device tables indexed [window, t] ((W,) for the reset values),
        # with W = 1 when the tables are not stacked over windows.
        self._tab = {}
        for f in dataclasses.fields(self.tables):
            if f.name not in tables_lib.STATIC_FIELDS:
                value = np.asarray(getattr(self.tables, f.name))
                if config.episode_windows == 1:
                    value = value[None]
                self._tab[f.name] = torch.as_tensor(value, device=dev)
        # The step tables' one length, T (unpacking raises if they differ).
        (self._table_steps,) = {v.shape[1] for v in self._tab.values() if v.dim() == 2}
        self.occupancy_params = occupancy_lib.make_occupancy_params(
            config.occupancy, config.time_step_sec
        )
        c = config.convection
        self.convection = convection_lib.make_convection_buckets(
            self.geom,
            c.p,
            c.distance,
            method=c.method,
            rounds=c.rounds,
            variants=c.variants,
            seed=c.seed,
            rng=c.rng,
            schedule=c.schedule,
        )
        self._conv_word_params = convection_lib.decision_word_params(
            self.convection
        )
        self._conv_lead = fdm_cuda.packed_plane(self.convection.lead_words, dev)
        self._conv_foll = fdm_cuda.packed_plane(self.convection.foll_words, dev)
        self._conv_flat = torch.as_tensor(
            self.convection.flat_indices.astype(np.int64), device=dev
        )
        self._conv_segments = torch.as_tensor(self.convection.segment_keys, device=dev)
        self.reward_params = reward_lib.make_reward_params(config.reward, device=dev)
        self.zone_stats = gridstats.make_zone_stat_layout(self.geom)
        self._stats = gridstats.ZoneStats(self.zone_stats, dev)
        # The kernels' routes by solver name, made at first use (`route`).
        self._routes: Dict[str, fdm_cuda.Route] = {}
        self.obs_layout = obs_lib.build_obs_layout(
            self.geom.zone_names,
            config.observation_normalization,
            config.histogram_parameters,
            ahu_has_outside_temp=config.hvac.ahu_observes_outside_air,
            num_hod_features=config.num_hod_features,
            num_dow_features=config.num_dow_features,
        )
        self._obs_layout = obs_lib.layout_on(self.obs_layout, dev)
        self._reset_temps = torch.as_tensor(
            np.asarray(self.geom.reset_temps, np.float32), device=dev
        )
        self._diffusers = torch.as_tensor(
            np.asarray(self.geom.diffusers, np.float32), device=dev
        )
        self._zone_ids = torch.as_tensor(
            np.asarray(self.geom.zone_ids, np.int64), device=dev
        )
        # Device constants of the step (made once: a captured step reads
        # them, graphs.py).
        f32 = dict(dtype=torch.float32, device=dev)
        self._dt = torch.tensor(config.time_step_sec, **f32)
        self._occ_norm = torch.tensor(config.occupancy_normalization_constant, **f32)
        self._zero = torch.tensor(0.0, **f32)
        self._build_actions(config)

    def _build_actions(self, config: EnvConfig) -> None:
        """Action layout over (device, field) tuples, in the JAX package's
        order (environment.py:591-707)."""
        if config.action_tuples is not None:
            candidates = [tuple(t) for t in config.action_tuples]
            missing = sorted(
                {f for _, f in candidates if f not in config.action_normalizers}
            )
            if missing:
                raise ValueError(f"action fields without a normalizer: {missing}")
        else:
            candidates = [
                (dev, field)
                for dev, field in [
                    ("boiler", "supply_water_setpoint"),
                    ("air_handler", "supply_air_cooling_temperature_setpoint"),
                    ("air_handler", "supply_air_heating_temperature_setpoint"),
                ]
                if field in config.action_normalizers
            ]
        zone_index = {n: i for i, n in enumerate(self.geom.zone_names)}
        known_fields = {
            "boiler": ("supply_water_setpoint",),
            "air_handler": (
                "supply_air_cooling_temperature_setpoint",
                "supply_air_heating_temperature_setpoint",
            ),
            "vav": ("supply_air_damper_percentage_command",),
        }
        self.action_entries = []
        vav_slots = []  # (zone index, action index) for per-VAV dampers
        for i, (dev, field) in enumerate(candidates):
            kind = "vav" if dev.startswith("vav_") else dev
            if kind not in known_fields or field not in known_fields[kind]:
                raise ValueError(f"unsupported action tuple ({dev!r}, {field!r})")
            if kind == "vav":
                zname = dev[len("vav_"):]
                if zname not in zone_index:
                    raise ValueError(
                        f"unknown VAV device {dev!r}; zones are "
                        f"{self.geom.zone_names}"
                    )
                vav_slots.append((zone_index[zname], i))
            self.action_entries.append((dev, field, config.action_normalizers[field]))
        # Device index tensors (a list index would be copied to the device
        # on every step).
        idx = dict(dtype=torch.int64, device=self.device)
        self._vav_action_zone_idx = torch.tensor([z for z, _ in vav_slots], **idx)
        self._vav_action_slot = torch.tensor([i for _, i in vav_slots], **idx)
        self.action_names = tuple(f"{d}_{f}" for d, f, _ in self.action_entries)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._action_low = torch.tensor(
            [n.min_native_value for _, _, n in self.action_entries], **f32
        )
        self._action_high = torch.tensor(
            [n.max_native_value for _, _, n in self.action_entries], **f32
        )

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------

    @property
    def n_actions(self) -> int:
        return len(self.action_entries)

    @property
    def obs_dim(self) -> int:
        return self.obs_layout.n_fields

    @property
    def n_zones(self) -> int:
        return self.geom.n_zones

    @property
    def steps_per_episode(self) -> int:
        return self.tables.n_steps

    def default_action(self, default_setpoints: Dict[str, float]) -> np.ndarray:
        """Normalized action vector for given native setpoints
        (environment.py:575-589)."""
        out = []
        for _, field, n in self.action_entries:
            native = default_setpoints[field]
            ratio = (native - n.min_native_value) / (
                n.max_native_value - n.min_native_value
            )
            out.append(
                ratio * (n.max_normalized_value - n.min_normalized_value)
                + n.min_normalized_value
            )
        return np.asarray(out, np.float32)

    # ------------------------------------------------------------------
    # Batched env functions
    # ------------------------------------------------------------------

    def reset(self, keys: torch.Tensor) -> Tuple[EnvState, torch.Tensor]:
        """Fresh episode states for a (B, 2) batch of keys + the initial
        observations (environment.py:1165); traced, the span
        `sbsim.env.reset`."""
        with profiling.span("sbsim.env.reset"):
            return self._reset(keys)

    def _reset(self, keys: torch.Tensor) -> Tuple[EnvState, torch.Tensor]:
        keys = keys.to(self.device, torch.int64)
        batch = keys.shape[0]
        dev = self.device
        hvac = initial_hvac_state(self.hvac_params, batch)
        occupants = occupancy_lib.initial_occupants(
            self.occupancy_params, batch, self.geom.n_zones, device=dev
        )
        sub = rng_lib.split(keys, 3)
        key, obs_key, window_key = sub[:, 0], sub[:, 1], sub[:, 2]
        if self.config.episode_windows > 1:
            window = rng_lib.randint(window_key, (), 0, self.config.episode_windows)
        else:
            window = torch.zeros(batch, dtype=torch.int32, device=dev)
        tab = self._state_tables(window)
        # Reset observation: boiler ramp initializes its action timestamp
        # with zero elapsed time (boiler.py:163-168).
        hvac = hvac_ops.boiler_observe_supply_temp(hvac, self.hvac_params, self._zero)

        occupants = self._occupancy_peek_randomized(
            occupants,
            obs_key,
            tab("reset_local_hour"),
            tab("reset_workday"),
        )
        temp = self._reset_temps.expand(batch, -1, -1).clone()
        zone_means, grid_mean = self._grid_stats(temp)
        i32 = dict(dtype=torch.int32, device=dev)
        state = EnvState(
            temp=temp,
            input_q=torch.zeros_like(temp),
            zone_means=zone_means,
            grid_mean=grid_mean,
            hvac=hvac,
            occupants=occupants,
            step_idx=torch.zeros(batch, **i32),
            window=window,
            rng=key.contiguous(),
            fdm_converged=torch.ones(batch, dtype=torch.bool, device=dev),
            fdm_iterations=torch.zeros(batch, **i32),
        )
        obs = self._observation(state, state.step_idx)
        return state, obs

    def _state_tables(self, window: torch.Tensor):
        """Per-env table view: tab(name, t) reads each env's episode window
        at step t ((B,) int64 indices), tab(name) its window's reset value,
        (B,). A step past the tables' end reads their last step, as a jnp
        gather clamps its index (a rollout that never resets runs on past
        the episode). Each index tensor is clamped once per view, however
        many tables read it: the step is launch-bound."""
        last = self._table_steps - 1
        clamped = {}  # id(t) -> (t, its clamp); t is held so its id stays its own

        def step(t: torch.Tensor) -> torch.Tensor:
            hit = clamped.get(id(t))
            if hit is None:
                hit = clamped[id(t)] = (t, t.clamp(0, last))
            return hit[1]

        if self.config.episode_windows == 1:
            def tab(name: str, t: Optional[torch.Tensor] = None) -> torch.Tensor:
                value = self._tab[name][0]
                return value.expand(window.shape) if t is None else value[step(t)]

            return tab
        w = window.to(torch.int64)

        def tab(name: str, t: Optional[torch.Tensor] = None) -> torch.Tensor:
            return self._tab[name][w] if t is None else self._tab[name][w, step(t)]

        return tab

    def _grid_stats(self, temp: torch.Tensor):
        """(zone_means (B, Z), grid_mean (B,)) by the deterministic fold."""
        return self._stats.zone_means(temp), self._stats.grid_mean(temp)

    def _occupancy_peek_randomized(self, occupants, key, local_hour, workday):
        if self.occupancy_params.kind != "randomized":
            return occupants
        return occupancy_lib.occupancy_peek(
            occupants, key, local_hour, workday, self.occupancy_params
        )

    def _zone_occupancy_at(self, occupants: torch.Tensor, t: torch.Tensor, tab):
        """Per-zone occupancy (B, Z) for the reward interval starting at t."""
        if self.occupancy_params.kind == "randomized":
            return occupancy_lib.zone_occupancy(occupants)
        occ = tab("step_occupancy", t)
        return occ[:, None].expand(-1, self.geom.n_zones)

    def resolve_solver(
        self, batch: int, use_pallas: bool = True, solver: Optional[str] = None
    ) -> str:
        """Name of the FDM path `step_batched` will run for this batch:
        an explicit name, else the CUDA kernel on the card ("pallas_env")
        and the plain batched solver on the CPU."""
        del batch
        if solver is not None and solver != "auto":
            if solver not in _SOLVERS:
                raise ValueError(
                    f"unknown solver {solver!r}; one of {sorted(_SOLVERS)}"
                )
            return solver
        if use_pallas and self.device.type == "cuda":
            return "pallas_env"
        return f"xla_{self.config.fdm_solver}"

    def capture(self, fn, solver: Optional[str] = None,
                op_by_op: bool = False) -> graphs.CapturedFunction:
        """`fn`, a program that steps this env through `solver`, as a
        captured program (graphs.py), or op by op by the rule the port's
        programs share: through a plain solver ("xla_*", physics/fdm.py),
        whose convergence loop reads the device back every iteration and
        cannot be captured, and where the caller says so (`op_by_op`: a
        gloo group's collectives, distributed/mesh.py); the kernels' routes
        ("pallas_*") are captured."""
        plain = self.resolve_solver(1, solver=solver).startswith("xla_")
        return graphs.capture(fn, op_by_op=op_by_op or plain)

    def route(self, solver: str) -> fdm_cuda.Route:
        """The FDM route of a kernel solver ("pallas_env": Jacobi,
        "pallas_cheby": Chebyshev) from the config's values, made at first
        use and kept as long as the env: a captured program reads its planes
        by address."""
        path = self._routes.get(solver)
        if path is None:
            if solver not in ("pallas_env", "pallas_cheby"):
                raise ValueError(f"no kernel route for solver {solver!r}")
            c = self.config
            path = self._routes[solver] = fdm_cuda.route(
                self.coeffs,
                method="chebyshev" if solver == "pallas_cheby" else "jacobi",
                threshold=c.convergence_threshold,
                iteration_limit=c.iteration_limit,
                spectral_radius=self._spectral_radius,
                check_every=c.cheby_check_every,
                block_mode=c.pallas_block_mode,
                block_envs=c.pallas_block_envs,
                convection=self.convection,
                conv_lead=self._conv_lead,
                conv_foll=self._conv_foll,
                stats=self._stats,
                max_stat_zones=c.kernel_stats_max_zones,
            )
        return path

    def kernel_path(self, solver: str) -> Tuple[bool, bool]:
        """(convection fused into the kernel, statistics from the kernel)
        for an FDM solver name: its route's (`route`), and neither for the
        plain solvers ("xla_*")."""
        if not solver.startswith("pallas"):
            return False, False
        path = self.route(solver)
        return path.fuse_conv, path.kernel_stats

    def step(self, state: EnvState, action: torch.Tensor) -> Tuple[EnvState, StepOutput]:
        """One control step of a single env, held as a batch of one: a
        (1, ...) state and a (1, n_actions) action in, the same batch out
        (the JAX package's per-env `step`, building_env.py:354-373).

        It is `step_batched` at B=1 (batch isolation is bitwise) with the
        solver the config names, as the JAX `step` takes it: fdm_solver
        "jacobi" runs "pallas_env" (K2 on the card), "chebyshev"
        "pallas_cheby" (K1), in the config's block layout; on the CPU the
        kernels' plain versions."""
        if state.temp.shape[0] != 1 or tuple(action.shape) != (1, self.n_actions):
            raise ValueError(
                f"step takes a batch of one env and a (1, {self.n_actions}) action; got "
                f"{state.temp.shape[0]} envs and an action of shape {tuple(action.shape)} "
                "(step_batched steps a batch)"
            )
        solver = "pallas_cheby" if self.config.fdm_solver == "chebyshev" else "pallas_env"
        return self.step_batched(state, action, solver=solver)

    @functools.cached_property
    def captured_step(self) -> graphs.CapturedFunction:
        """`step` as a captured program (graphs.py), made once per env and
        shared by its callers: the counterpart of `jax.jit(env.step)` at the
        JAX package's per-env call sites (envs/host_adapter.py, the
        dashboard, the parity day). Its `eager` is `step` op by op."""
        return graphs.capture(self.step)

    def step_batched(
        self,
        states: EnvState,
        actions: torch.Tensor,
        use_pallas: bool = True,
        solver: Optional[str] = None,
    ) -> Tuple[EnvState, StepOutput]:
        """One control step for the env batch. `solver` selects the FDM path
        ("pallas_env", "pallas_cheby", "xla_jacobi", "xla_chebyshev");
        None/"auto" resolves via resolve_solver. Traced, the span
        `sbsim.env.step` with its phases as children: `.control`
        (`_step_pre`), `.fdm`, `.convect` (after the solve, where it is not
        fused into the kernel), `.stats` and `.post` (`_step_post`); inside
        a captured program they run at capture."""
        with profiling.span("sbsim.env.step"):
            with profiling.span("sbsim.env.control"):
                pre, conv_keys = self._step_pre(states, actions)
            solver = self.resolve_solver(
                states.temp.shape[0], use_pallas=use_pallas, solver=solver
            )
            fuse_conv, _ = self.kernel_path(solver)
            sums = barriers = None
            with profiling.span("sbsim.env.fdm"):
                if solver.startswith("pallas"):
                    new_temp, n_iter, converged, sums, barriers = self.route(solver).solve(
                        states.temp, states.input_q, pre["ambient"], pre["h_conv"], conv_keys)
                else:
                    new_temp, converged, n_iter = self._solve_fdm(
                        states.temp,
                        states.input_q,
                        pre["ambient"],
                        pre["h_conv"],
                        kind=solver[len("xla_"):],
                    )
            if not fuse_conv and self.convection.enabled:
                with profiling.span("sbsim.env.convect"):
                    new_temp = self._convect(new_temp, conv_keys)
            with profiling.span("sbsim.env.stats"):
                if sums is not None:
                    new_zm = sums.zone_sums / self._stats.sizes
                    new_gm = sums.grid_sums / self.zone_stats.grid_n
                else:
                    new_zm, new_gm = self._grid_stats(new_temp)
            with profiling.span("sbsim.env.post"):
                new_state, out = self._step_post(
                    states, pre, new_temp, converged, n_iter, new_zm, new_gm
                )
            if barriers is not None:
                out = dataclasses.replace(out, fdm_barriers=barriers)
            return new_state, out

    def _convect(self, temp: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        """convection.apply_convection with the env's device planes."""
        conv = self.convection
        if conv.method != "swap":
            return convection_lib.apply_argsort(
                temp, self._conv_flat, self._conv_segments, keys
            )
        word = convection_lib.swap_decision_word(conv, keys, self.geom.shape)
        return fdm_cuda.convect(temp, fdm_cuda.ConvInputs(
            offsets=conv.offsets, lead=self._conv_lead, foll=self._conv_foll,
            words=word,
        ))

    def _solve_fdm(self, temp, input_q, ambient, h_conv, kind=None):
        kind = kind or self.config.fdm_solver
        if kind == "chebyshev":
            return fdm.fdm_step_chebyshev(
                temp, input_q, ambient, h_conv, self.coeffs,
                convergence_threshold=self.config.convergence_threshold,
                iteration_limit=self.config.iteration_limit,
                spectral_radius=self._spectral_radius,
            )
        return fdm.fdm_step(
            temp, input_q, ambient, h_conv, self.coeffs,
            convergence_threshold=self.config.convergence_threshold,
            iteration_limit=self.config.iteration_limit,
        )

    def _step_pre(
        self, state: EnvState, action: torch.Tensor
    ) -> Tuple[Dict[str, object], torch.Tensor]:
        """Control phase: everything before (and independent of) the FDM."""
        params = self.hvac_params
        tab = self._state_tables(state.window)
        t = state.step_idx.to(torch.int64)

        sub = rng_lib.split(state.rng, 4)
        rng, conv_key, obs_key, reward_key = (sub[:, i] for i in range(4))

        # ---- Phase 1: request_action -------------------------------------
        zone_temps = state.zone_means
        comfort_now = tab("comfort", t)
        mode = hvac_ops.thermostat_update(
            state.hvac.thermostat_mode,
            zone_temps,
            tab("heating_setpoint", t),
            tab("cooling_setpoint", t),
            comfort_now,
            state.hvac.prev_comfort,
        )
        damper, valve = hvac_ops.vav_settings_for_mode(
            mode, state.hvac.damper, state.hvac.reheat_valve
        )
        hvac = state.hvac.replace(
            thermostat_mode=mode,
            damper=damper,
            reheat_valve=valve,
            zone_air_temp=zone_temps,
            prev_comfort=comfort_now,
        )

        # Agent setpoints: linear map [-1, 1] -> native bounds
        # (bounded_action_normalizer.py:73-98).
        act = torch.clamp(action.to(self.device, torch.float32), -1.0, 1.0)
        native = (act + 1.0) / 2.0 * (
            self._action_high - self._action_low
        ) + self._action_low
        setters: Dict[str, torch.Tensor] = {}
        for i, (dev, field, _) in enumerate(self.action_entries):
            if not dev.startswith("vav_"):
                setters[field] = native[:, i]
        # Per-VAV damper commands override the thermostat defaults
        # (simulator_building.py:204-263).
        if self._vav_action_slot.numel():
            damper = hvac.damper.clone()
            damper[:, self._vav_action_zone_idx] = native[:, self._vav_action_slot]
            hvac = hvac.replace(damper=damper)
        if "supply_water_setpoint" in setters:
            hvac = hvac.replace(
                boiler_setpoint=setters["supply_water_setpoint"],
                boiler_has_action=torch.ones_like(hvac.boiler_has_action),
            )
        if "supply_air_heating_temperature_setpoint" in setters:
            hvac = hvac.replace(
                ahu_heating_setpoint=setters["supply_air_heating_temperature_setpoint"]
            )
        if "supply_air_cooling_temperature_setpoint" in setters:
            hvac = hvac.replace(
                ahu_cooling_setpoint=setters["supply_air_cooling_temperature_setpoint"]
            )

        # ---- Phase 2 (pre-FDM): demand accumulation ----------------------
        ambient = tab("ambient_temp", t)
        h_conv = tab("convection_coeff", t)
        supply_air_temp = hvac_ops.ahu_supply_air_temp(
            state.grid_mean,
            ambient,
            hvac.ahu_heating_setpoint,
            hvac.ahu_cooling_setpoint,
            params,
        )
        # VAV outputs use the *pre-step* zone temps (one-step delay,
        # simulator_flexible_floor_plan.py:134, 165-179).
        q_zone, zone_supply_temps = hvac_ops.vav_output(
            zone_temps,
            supply_air_temp,
            hvac.boiler_setpoint,
            hvac.damper,
            hvac.reheat_valve,
            params,
        )
        flow_demands = hvac.damper * params.vav_max_air_flow_rate
        reheat_demands = hvac.reheat_valve * params.vav_reheat_max_water_flow_rate
        ahu_flow, cooling_count = hvac_ops.ahu_accumulate_demand(flow_demands, params)
        boiler_flow, heating_count = hvac_ops.boiler_accumulate_demand(reheat_demands)
        return_water = hvac_ops.return_water_temperature(
            hvac.reheat_valve, zone_supply_temps
        )
        hvac = hvac.replace(
            ahu_air_flow_rate=ahu_flow,
            ahu_cooling_request_count=cooling_count,
            boiler_total_flow_rate=boiler_flow,
            boiler_heating_request_count=heating_count,
            boiler_return_water_temp=return_water,
        )
        # Diffuser heat for the *next* FDM step (building.py:873-889).
        zone_q = torch.cat([q_zone, torch.zeros_like(q_zone[:, :1])], dim=1)
        new_input_q = self._diffusers * zone_q[:, self._zone_ids]

        pre = {
            "hvac": hvac,
            "new_input_q": new_input_q,
            "ambient": ambient,
            "h_conv": h_conv,
            "rng": rng.contiguous(),
            "obs_key": obs_key,
            "reward_key": reward_key,
            "t": t,
            "tab": tab,
        }
        return pre, conv_key.contiguous()

    def _step_post(
        self,
        state: EnvState,
        pre: Dict[str, object],
        new_temp: torch.Tensor,
        converged: torch.Tensor,
        n_iter: torch.Tensor,
        new_zone_means: torch.Tensor,
        new_grid_mean: torch.Tensor,
    ) -> Tuple[EnvState, StepOutput]:
        """Observation + reward at t+1, after the physics solve."""
        tab, t = pre["tab"], pre["t"]
        t_next = t + 1
        dt = self._dt

        # ---- Phase 3: observation at t+1 ---------------------------------
        # Occupancy peek for the observation probes [t, t+1]
        # (simulator_building.py:305-315).
        occupants = self._occupancy_peek_randomized(
            state.occupants, pre["obs_key"], tab("local_hour", t), tab("workday_local", t)
        )
        hvac = hvac_ops.boiler_observe_supply_temp(pre["hvac"], self.hvac_params, dt)
        mid_state = EnvState(
            temp=new_temp,
            input_q=pre["new_input_q"],
            zone_means=new_zone_means,
            grid_mean=new_grid_mean,
            hvac=hvac,
            occupants=occupants,
            step_idx=state.step_idx + 1,
            window=state.window,
            rng=pre["rng"],
            fdm_converged=converged,
            fdm_iterations=n_iter.to(torch.int32),
        )
        obs = self._observation(mid_state, t_next, tab)

        # ---- Phase 4: reward at t+1 --------------------------------------
        # Second occupancy peek for the reward interval [t+1, t+2]
        # (randomized draws advance again, simulator.py:471-475).
        occupants = self._occupancy_peek_randomized(
            occupants,
            pre["reward_key"],
            tab("local_hour", t_next),
            tab("workday_local", t_next),
        )
        zone_occ = self._zone_occupancy_at(occupants, t_next, tab)
        breakdown = self._reward(mid_state, new_zone_means, zone_occ, t_next, dt, tab)
        new_state = mid_state.replace(occupants=occupants)
        out = StepOutput(
            observation=obs,
            reward=breakdown.agent_reward_value,
            done=t_next >= self.tables.n_steps,
            reward_breakdown=breakdown,
        )
        return new_state, out

    def _reward(self, state, zone_temps, zone_occ, t, dt, tab):
        """3C regret from the post-step state (environment.py:1073-1097);
        `tab` is the state's table view."""
        params = self.hvac_params
        hvac = state.hvac
        ambient = tab("ambient_temp", t)
        blower = hvac_ops.ahu_blower_power(hvac, params)
        ac = hvac_ops.ahu_thermal_energy_rate(hvac, state.grid_mean, ambient, params)
        pump = hvac_ops.boiler_pump_power(hvac, params)
        gas = hvac_ops.boiler_thermal_energy_rate(hvac, ambient, params)
        return reward_lib.compute_regret_reward(
            heating_setpoint=tab("heating_setpoint", t),
            cooling_setpoint=tab("cooling_setpoint", t),
            zone_temps=zone_temps,
            zone_occupancy=zone_occ,
            electricity_energy_rate=blower + torch.abs(ac) + pump,
            natural_gas_energy_rate=gas,
            elec_price=tab("elec_price", t),
            elec_carbon=tab("elec_carbon", t),
            gas_price=tab("gas_price", t),
            dt_sec=dt,
            params=self.reward_params,
        )

    def device_values(self, state: EnvState, t_obs: torch.Tensor, tab=None):
        """Native (unnormalized) observable values per device class:
        (ahu_values, boiler_values, vav_values), (B,) and (B, Z) tensors
        (simulator_building.py:151-202). `tab` is the state's table view
        where the caller has one."""
        params = self.hvac_params
        tab = tab or self._state_tables(state.window)
        hvac = state.hvac
        flow = hvac.ahu_air_flow_rate
        fan_pct = flow / params.ahu_max_air_flow_rate
        ahu_values = {
            "cooling_request_count": hvac.ahu_cooling_request_count.to(torch.float32),
            "differential_pressure_setpoint": params.ahu_fan_differential_pressure,
            "discharge_fan_speed_percentage_command": fan_pct,
            "outside_air_flowrate_sensor": (1.0 - params.ahu_recirculation) * flow,
            "outside_air_temperature_sensor": tab("ambient_temp", t_obs),
            "supply_air_cooling_temperature_setpoint": hvac.ahu_cooling_setpoint,
            "supply_air_flowrate_sensor": flow,
            "supply_air_heating_temperature_setpoint": hvac.ahu_heating_setpoint,
            "supply_fan_speed_percentage_command": fan_pct,
        }
        boiler_values = {
            "heating_request_count": hvac.boiler_heating_request_count.to(torch.float32),
            "supply_water_setpoint": hvac.boiler_setpoint,
            "supply_water_temperature_sensor": hvac.boiler_current_temp,
        }
        vav_values = {
            "supply_air_damper_percentage_command": hvac.damper,
            "supply_air_flowrate_setpoint": params.vav_max_air_flow_rate,
            "zone_air_temperature_sensor": hvac.zone_air_temp,
        }
        return ahu_values, boiler_values, vav_values

    def _observation(self, state: EnvState, t_obs: torch.Tensor, tab=None) -> torch.Tensor:
        """Flat normalized observations (B, obs_dim) at table index t_obs;
        `tab` is the state's table view where the caller has one."""
        t_obs = t_obs.to(torch.int64)
        tab = tab or self._state_tables(state.window)
        ahu_values, boiler_values, vav_values = self.device_values(state, t_obs, tab)
        if self.occupancy_params.kind == "randomized":
            total_occ = occupancy_lib.zone_occupancy(state.occupants).sum(dim=-1)
        else:
            # Average over the trailing 5-minute window per zone
            # (simulator_building.py:305-315).
            probe = t_obs - 1  # tab clamps it into [0, T-1], as max(t - 1, 0) then the gather
            total_occ = tab("step_occupancy", probe) * self.geom.n_zones
        # int() truncation then occupancy normalization
        # (simulator_building.py:315, environment.py:952-956).
        c = self._occ_norm
        num_occupants = (torch.trunc(total_occ) - c) / (c + 1.0)
        return obs_lib.assemble_observation(
            self._obs_layout,
            ahu_values=ahu_values,
            boiler_values=boiler_values,
            vav_values=vav_values,
            hod_rad=tab("hod_rad", t_obs),
            dow_rad=tab("dow_rad", t_obs),
            comfort_now=tab("comfort", t_obs),
            comfort_soon=tab("comfort_soon", t_obs),
            num_occupants=num_occupants,
        )


def build_geometry(config: EnvConfig) -> BuildingGeometry:
    """Builds the BuildingGeometry described by an EnvConfig."""
    b = config.building
    if b.kind == "floor_plan":
        plan = b.floor_plan
        if plan is None and b.floor_plan_path:
            from sbsim_tpu_torch.core import floorplan as floorplan_lib

            plan = floorplan_lib.read_floor_plan(b.floor_plan_path)
        if plan is None:
            raise ValueError("floor_plan or floor_plan_path required")
        geom = geometry_lib.geometry_from_floor_plan(
            plan,
            cv_size_cm=b.cv_size_cm,
            floor_height_cm=b.floor_height_cm,
            initial_temp=b.initial_temp,
            inside_air=b.inside_air,
            inside_wall=b.inside_wall,
            exterior_wall=b.building_exterior,
            zone_map=b.zone_map,
            buffer_from_walls=b.buffer_from_walls,
            reset_temps=b.reset_temps,
        )
    elif b.kind == "rectangular":
        geom = geometry_lib.geometry_rectangular(
            cv_size_cm=b.cv_size_cm,
            floor_height_cm=b.floor_height_cm,
            room_shape=b.room_shape,
            building_shape=b.building_shape,
            initial_temp=b.initial_temp,
            inside_air=b.inside_air,
            inside_wall=b.inside_wall,
            building_exterior=b.building_exterior,
        )
    else:
        raise ValueError(f"Unknown building kind: {b.kind}")

    if geometry_lib.layout_transposed(b.layout, geom.shape):
        geom = geometry_lib.transpose_geometry(geom)
    return geom
