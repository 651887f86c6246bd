"""The offline-learning path: the port against the JAX package on the CPU.

`sbsim_tpu_torch/utils/` frames recorded telemetry without pandas, on its
own `Frame`. Here every function is held to its JAX counterpart on the same
inputs:

* a `Frame` equals the DataFrame the JAX function returns: the same
  columns in the same order, the same index, float values bitwise
  (`df.to_numpy(float)`, NaN equal to NaN) and the object columns
  (timestamps, strings) element for element;
* protos are built in both packages from the same bytes and compared as
  bytes (`SerializeToString(deterministic=True)` on the JAX side);
* energy to rtol 1e-12 (the same numpy code: bitwise in practice);
* the pipeline of tests/test_regression_pipeline.py: 36 steps of
  two_zone_test_config() recorded by the port, framed by both packages
  from the same shards into bitwise-equal tables, a least-squares fit on
  them driving both RegressionBuildings for 10 steps with byte-equal
  protos.
"""

import datetime
import glob
import math

import numpy as np
import pandas as pd
import pytest

from sbsim_tpu import interfaces as jinterfaces
from sbsim_tpu.io import records as jrecords
from sbsim_tpu.proto import building_pb2 as jbuilding
from sbsim_tpu.proto import reward_pb2 as jreward
from sbsim_tpu.utils import energy as jenergy
from sbsim_tpu.utils import reducers as jreducers
from sbsim_tpu.utils import regression as jreg
from sbsim_tpu.utils import run_command_predictor as jrcp
from sbsim_tpu.utils import telemetry as jtelemetry
from sbsim_tpu.utils import testing as jtesting
from sbsim_tpu_torch import interfaces as tinterfaces
from sbsim_tpu_torch.envs import building_env as tbe
from sbsim_tpu_torch.envs import host_adapter as tha
from sbsim_tpu_torch.envs import host_environment as the
from sbsim_tpu_torch.envs import presets as tpresets
from sbsim_tpu_torch.io import records as trecords
from sbsim_tpu_torch.proto import building_pb2 as tbuilding
from sbsim_tpu_torch.utils import energy as tenergy
from sbsim_tpu_torch.utils import frame as tframe
from sbsim_tpu_torch.utils import reducers as treducers
from sbsim_tpu_torch.utils import regression as treg
from sbsim_tpu_torch.utils import run_command_predictor as trcp
from sbsim_tpu_torch.utils import telemetry as ttelemetry
from sbsim_tpu_torch.utils import testing as ttesting

UTC = datetime.timezone.utc
TS0 = datetime.datetime(2023, 7, 6, 7, tzinfo=UTC)
STEP = datetime.timedelta(minutes=5)
TEMP = "zone_air_temperature_sensor"
N_STEPS = 36


def _pd(ts):
    return pd.Timestamp(ts)


def _jax(msg, jax_type):
    """A port message as the protobuf message of the same bytes."""
    return jax_type.FromString(msg.SerializeToString())


def _same_bytes(port_msg, jax_msg) -> bool:
    return port_msg.SerializeToString() == jax_msg.SerializeToString(deterministic=True)


def _same_label(got, want) -> bool:
    if want is None or (not isinstance(want, str) and pd.isna(want)):
        return got is None or (isinstance(got, float) and math.isnan(got))
    return got == want


def assert_frame_is(frame, df):
    """`frame` equals the DataFrame `df` (see the module docstring)."""
    assert frame.columns == list(df.columns)
    assert len(frame) == len(df)
    assert all(_same_label(a, b) for a, b in zip(frame.index, df.index, strict=True))
    for j, col in enumerate(frame.columns):
        if col in frame.objects:
            assert all(_same_label(a, b) for a, b in
                       zip(frame.objects[col], df.iloc[:, j], strict=True)), col
        else:
            np.testing.assert_array_equal(frame.values[:, j], df.iloc[:, j].to_numpy(float),
                                          err_msg=str(col))
    if not frame.objects:
        np.testing.assert_array_equal(frame.to_numpy(), df.to_numpy(float))


# ---- Frame -------------------------------------------------------------------------------


ROWS = [
    {("vav_1", TEMP): 294.0, "hod": 0.5},
    {("vav_2", TEMP): 296.5, ("vav_1", TEMP): np.nan},
    {"hod": -1.0, ("ahu", "flow"): 3.0},
    {},
]


@pytest.mark.parametrize("columns", [None, ["hod", ("vav_1", TEMP), ("ghost", "x")]])
def test_frame_from_rows_is_the_dataframe(columns):
    """First-seen column order without columns; a missing key is NaN, keys
    outside the columns are dropped."""
    assert_frame_is(tframe.Frame.from_rows(ROWS, columns=columns),
                    pd.DataFrame(ROWS, columns=columns))


def _labelled(n, offset=0):
    return [TS0 + (i + offset) * STEP for i in range(n)]


def test_frame_set_index_join_dropna_drop_and_loc():
    a_rows = [{"timestamp": t, ("d", "x"): float(i), ("d", "y"): (np.nan if i == 2 else 2.0 * i)}
              for i, t in enumerate(_labelled(6))]
    b_rows = [{"timestamp": t, ("action", "d", "s"): 10.0 + i}
              for i, t in enumerate(_labelled(5, offset=2)[::-1])]
    ta, tb = (tframe.Frame.from_rows(r).set_index("timestamp") for r in (a_rows, b_rows))
    ja, jb = (pd.DataFrame(r).set_index("timestamp") for r in (a_rows, b_rows))
    assert_frame_is(ta, ja)
    assert_frame_is(ta.join(tb, how="inner"), ja.join(jb, how="inner"))
    assert_frame_is(ta.dropna(), ja.dropna())
    assert_frame_is(ta.drop(columns=[("d", "y")]), ja.drop(columns=[("d", "y")]))
    rows, cols = _labelled(3, offset=3)[::-1], [("d", "y"), ("d", "x")]
    np.testing.assert_array_equal(ta.loc[rows, cols], ja.loc[rows, cols].to_numpy(float))
    unindexed = tframe.Frame.from_rows(a_rows)
    assert unindexed.objects and unindexed.dropna().index == [0, 1, 3, 4, 5]


def test_frame_row_statistics_are_pandas():
    """skipna means, ddof=1 std, medians; an all-NaN row and the std of one
    value give NaN."""
    values = np.random.default_rng(0).normal(295.0, 2.0, (6, 5))
    values[1, 2] = np.nan
    values[3] = np.nan
    values[4, 1:] = np.nan
    cols = [(f"vav_{i}", TEMP) for i in range(5)]
    frame, df = tframe.Frame(values, cols), pd.DataFrame(values, columns=cols)
    for stat in ("mean", "std", "median"):
        np.testing.assert_array_equal(getattr(frame, stat)(axis=1),
                                      getattr(df, stat)(axis=1).to_numpy())
    one = tframe.Frame(values[:, :1], cols[:1])
    np.testing.assert_array_equal(one.std(axis=1), pd.DataFrame(values[:, :1]).std(axis=1))
    assert np.isnan(one.std(axis=1)).all()


def test_frame_pivot_table_and_ffill_are_pandas():
    """Two devices, a duplicated timestamp (a group of three values: pandas'
    compensated mean), a NaN value and a timestamp with none."""
    t = _labelled(4)
    rows = [
        (t[1], "boiler", "sws", 340.0), (t[0], "boiler", "sws", 320.1),
        (t[0], "boiler", "sws", 350.3), (t[0], "boiler", "sws", 1e-9),
        (t[0], "ahu", "sat", 290.0), (t[2], "ahu", "sat", np.nan),
        (t[3], "boiler", "sws", 330.0), (t[2], "boiler", "sws", np.nan),
    ]
    long = [dict(timestamp=a, device_id=b, setpoint_name=c, value=d) for a, b, c, d in rows]
    kw = dict(index="timestamp", columns=["device_id", "setpoint_name"], values="value")
    got = tframe.Frame.from_rows(long).pivot_table(**kw)
    want = pd.DataFrame(long).pivot_table(**kw)
    assert got.columns == [tuple(c) for c in want.columns]
    np.testing.assert_array_equal(got.values, want.to_numpy(float))
    assert got.index == list(want.index)
    np.testing.assert_array_equal(got.ffill().to_numpy(), want.ffill().to_numpy(float))


# ---- telemetry ---------------------------------------------------------------------------


def _obs_response(values, ts, invalid=()):
    out = ttesting.observation_response(values, timestamp=ts)
    for single in out.single_observation_responses:
        req = single.single_observation_request
        if (req.device_id, req.measurement_name) in invalid:
            single.observation_valid = False
    return out


def _obs_stream(n=5, seed=0):
    """Responses with a NaN reading, an invalid one and a key missing from
    some responses."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        values = {("vav_1", TEMP): 294.0 + rng.normal(), ("vav_2", TEMP): 295.0 + rng.normal(),
                  ("ahu", "supply_air_flowrate_sensor"): rng.uniform(0, 3)}
        if i == 1:
            values[("vav_2", TEMP)] = np.nan
        if i % 2:
            values[("boiler", "supply_water_temperature_sensor")] = 330.0 + i
        out.append(_obs_response(values, TS0 + i * STEP,
                                 invalid={("vav_1", TEMP)} if i == 3 else ()))
    return out


def test_observation_responses_to_frame_is_the_dataframe():
    responses = _obs_stream()
    got = ttelemetry.observation_responses_to_frame(responses)
    want = jtelemetry.observation_responses_to_frame(
        [_jax(r, jbuilding.ObservationResponse) for r in responses])
    assert_frame_is(got, want)


def test_paint_zone_temperatures_is_jax():
    grid = np.asarray([[0, 0, 2], [1, 1, 2], [3, 1, 0]])
    values = {"zone_a": 290.5, "zone_c": 301.25}
    for fill in (np.nan, 285.0):
        np.testing.assert_array_equal(
            ttelemetry.paint_zone_temperatures(values, grid, ["zone_a", "zone_b", "zone_c"], fill),
            jtelemetry.paint_zone_temperatures(values, grid, ["zone_a", "zone_b", "zone_c"], fill))


# ---- energy ------------------------------------------------------------------------------


_T = np.linspace(250.0, 340.0, 13)
ENERGY_CASES = [
    ("water_vapor_partial_pressure", (_T,), {}),
    ("humidity_ratio", (_T, np.linspace(0.1, 0.9, 13), np.full(13, 1.01)), {}),
    ("air_conditioning_energy_rate", (), dict(
        air_flow_rates=np.linspace(0.5, 3.0, 13), outside_temps=_T,
        outside_relative_humidities=np.full(13, 0.4), supply_temps=np.full(13, 290.0),
        ambient_pressures=np.full(13, 1.0))),
    ("fan_power", (), dict(design_hp=7.5)),
    ("fan_power", (), dict(brake_hp=4.0, fan_speed_percentage=63.0, supply_static_pressure=0.5,
                           num_fans=2)),
    ("fan_power", (), dict(design_hp=7.5, supply_static_pressure=0.1, motor_factor=0.9)),
    ("air_volumetric_flowrate", (), dict(average_fan_speed_percentage=55.0, design_cfm=12000.0)),
    ("compressor_power_thermal", (), dict(mixed_air_temp=78.0, supply_air_temp=55.0,
                                          volumetric_flow_rate=9000.0, fan_heat_temp=1.5)),
    ("compressor_power_thermal", (), dict(mixed_air_temp=78.0, supply_air_temp=55.0,
                                          volumetric_flow_rate=9000.0, fan_speed_percentage=3.0)),
    ("compressor_power_utilization", (), dict(design_capacity=40.0, cooling_percentage=35.0)),
    ("compressor_power_utilization", (), dict(design_capacity=40.0, count_stages_on=2,
                                              total_stages=3, eer=10.5)),
    ("water_pump_power", (), dict(pump_duty_cycle=0.7, pump_speed_percentage=80.0,
                                  design_motor_horse_power=10.0, num_pumps=2)),
    ("water_pump_power", (), dict(pump_duty_cycle=1.0, brake_horse_power=6.0)),
    ("water_volumetric_flow_rate", (), dict(design_flow_rate=120.0, pump_speed_percentage=75.0,
                                            num_pumps_on=2)),
    ("water_heating_energy_rate", (), dict(volumetric_flow_rate=80.0,
                                           supply_water_temperature=160.0,
                                           return_water_temperature=140.0)),
    ("water_heating_energy_rate", (), dict(volumetric_flow_rate=80.0,
                                           supply_water_temperature=130.0,
                                           return_water_temperature=140.0)),
    ("water_heating_energy_rate_primary", (), dict(
        design_boiler_flow_rate=90.0, boiler_outlet_temperature=170.0,
        return_water_temperature=150.0, num_active_boilers=2)),
    ("water_heating_energy_rate_primary_secondary", (), dict(
        design_primary_boiler_flow_rate=90.0, design_secondary_boiler_flow_rate=70.0,
        boiler_outlet_temperature=170.0, return_water_temperature=150.0)),
]


@pytest.mark.parametrize("name,args,kwargs", ENERGY_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(ENERGY_CASES)])
def test_energy_is_jax(name, args, kwargs):
    got = getattr(tenergy, name)(*args, **kwargs)
    want = getattr(jenergy, name)(*args, **kwargs)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.shape(got) == np.shape(want)


@pytest.mark.parametrize("name,kwargs", [
    ("fan_power", {}),
    ("compressor_power_utilization", dict(design_capacity=1.0, cooling_percentage=120.0)),
    ("compressor_power_utilization", dict(design_capacity=1.0, count_stages_on=1,
                                          total_stages=0)),
    ("compressor_power_utilization", dict(design_capacity=1.0, count_stages_on=4,
                                          total_stages=3)),
    ("compressor_power_utilization", dict(design_capacity=1.0)),
    ("water_pump_power", dict(pump_duty_cycle=1.0)),
])
def test_energy_refuses_as_jax(name, kwargs):
    for module in (tenergy, jenergy):
        with pytest.raises(ValueError):
            getattr(module, name)(**kwargs)


# ---- reducers ----------------------------------------------------------------------------


def _reducer_inputs():
    responses = _obs_stream(n=7, seed=3)
    return (ttelemetry.observation_responses_to_frame(responses),
            jtelemetry.observation_responses_to_frame(
                [_jax(r, jbuilding.ObservationResponse) for r in responses]))


def test_identity_and_stats_reducers_are_jax():
    frame, df = _reducer_inputs()
    got, want = treducers.IdentityReducer().reduce(frame), jreducers.IdentityReducer().reduce(df)
    assert_frame_is(got.reduced_sequence, want.reduced_sequence)
    assert_frame_is(got.expand(), want.expand())
    got, want = treducers.StatsReducer().reduce(frame), jreducers.StatsReducer().reduce(df)
    assert_frame_is(got.reduced_sequence, want.reduced_sequence)
    assert_frame_is(got.expand(), want.expand())


def test_clipped_histogram_and_bin_assignment_are_jax():
    values = np.asarray([284.0, 285.0, 290.0, 294.99, 295.0, 305.0, np.nan])
    for clip in (True, False):
        got = treducers.clipped_histogram(values, [285.0, 290.0, 295.0], clip=clip)
        want = jreducers.clipped_histogram(values, [285.0, 290.0, 295.0], clip=clip)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    devices = dict(zip("abcdefg", values))
    assert (dict(treducers.assign_devices_to_bins(devices, [285.0, 290.0, 295.0]))
            == dict(jreducers.assign_devices_to_bins(devices, [285.0, 290.0, 295.0])))


@pytest.mark.parametrize("normalize", [False, True])
def test_histogram_reducer_is_jax(normalize):
    frame, df = _reducer_inputs()
    params = {TEMP: (285.0, 293.0, 295.0, 305.0)}
    got = treducers.HistogramReducer(params, normalize_reduce=normalize).reduce(frame)
    want = jreducers.HistogramReducer(params, normalize_reduce=normalize).reduce(df)
    assert_frame_is(got.reduced_sequence, want.reduced_sequence)
    assert_frame_is(got.expand(), want.expand())


# ---- regression: framing -----------------------------------------------------------------


def _devices(testing, pb):
    return [
        testing.device_info("vav_1", pb.DeviceInfo.VAV, "zone_a", observable_fields=[TEMP]),
        testing.device_info("vav_2", pb.DeviceInfo.VAV, "zone_b",
                            observable_fields=[TEMP, jreg.ZONE_HEAT_SETPOINT]),
        testing.device_info("boiler", pb.DeviceInfo.BLR, action_fields=["supply_water_setpoint"]),
        testing.device_info("air_handler", pb.DeviceInfo.AHU,
                            action_fields=["supply_air_heating_temperature_setpoint"]),
    ]


def _zones(pb):
    out = []
    for zone, devices in (("zone_a", ["vav_1"]), ("zone_b", ["boiler", "vav_2"]),
                          ("zone_c", ["ghost"])):
        z = pb.ZoneInfo(zone_id=zone)
        z.devices.extend(devices)
        out.append(z)
    return out


def _action_responses(n=4):
    """Port ActionResponses with an accepted and a rejected command each."""
    allowed = treg.device_action_tuples(_devices(ttesting, tbuilding))
    out = []
    for i in range(n):
        request = ttesting.action_request(
            {("boiler", "supply_water_setpoint"): 330.0 + i,
             ("ghost", "supply_water_setpoint"): 350.0 + i,
             ("air_handler", "supply_air_heating_temperature_setpoint"): 290.0 - i},
            timestamp=TS0 + i * STEP)
        out.append(treg.build_action_response(request, TS0 + i * STEP, allowed))
    return out


def _reward_infos(n=4):
    return [ttesting.reward_info({"zone_a": 295.0 + i}, blower_rate=10.0 * i, ac_rate=-20.0,
                                 gas_rate=30.0 + i, pump_rate=4.5, start=TS0 + i * STEP)
            for i in range(n)]


@pytest.mark.parametrize("time_zone,n_hod,n_dow", [("UTC", 1, 1), ("US/Pacific", 3, 2)])
def test_maps_and_sequences_are_jax(time_zone, n_hod, n_dow):
    responses = _obs_stream()
    jresponses = [_jax(r, jbuilding.ObservationResponse) for r in responses]
    keys = treg.feature_tuples(responses[0])
    assert keys == jreg.feature_tuples(jresponses[0])
    for r, jr in zip(responses, jresponses):
        got = treg.feature_map(r, time_zone, n_hod, n_dow)
        want = jreg.feature_map(jr, time_zone, n_hod, n_dow)
        assert list(got) == list(want)
        assert all(_same_label(got[k], want[k]) for k in got)
    assert_frame_is(treg.observation_sequence(responses, keys, time_zone, n_hod, n_dow),
                    jreg.observation_sequence(jresponses, keys, time_zone, n_hod, n_dow))

    actions = _action_responses()
    jactions = [_jax(a, jbuilding.ActionResponse) for a in actions]
    keys = treg.action_tuples(actions[0])
    assert keys == jreg.action_tuples(jactions[0])
    got = treg.action_sequence(actions, keys, time_zone)
    assert_frame_is(got, jreg.action_sequence(jactions, keys, time_zone))
    assert np.isnan(got[(treg.ACTION, "ghost", "supply_water_setpoint")]).all()

    infos = _reward_infos()
    jinfos = [_jax(r, jreward.RewardInfo) for r in infos]
    keys = treg.reward_info_tuples(infos[0])
    assert keys == jreg.reward_info_tuples(jinfos[0])
    assert_frame_is(treg.reward_info_sequence(infos, keys, time_zone),
                    jreg.reward_info_sequence(jinfos, keys, time_zone))
    assert (treg.device_action_tuples(_devices(ttesting, tbuilding))
            == jreg.device_action_tuples(_devices(jtesting, jbuilding)))


def test_match_sequence_indexes_is_jax():
    """Unsorted gaps, a NaN row in the inputs and one in the outputs."""
    t_in, t_out = _labelled(8), [TS0 + i * STEP for i in (1, 2, 4, 5, 6, 9)]
    x = np.arange(8.0)
    x[5] = np.nan
    y = np.arange(6.0)
    y[3] = np.nan
    got = treg.match_sequence_indexes(tframe.Frame(x[:, None], ["x"], t_in),
                                      tframe.Frame(y[:, None], ["y"], t_out), STEP)
    want = jreg.match_sequence_indexes(pd.DataFrame({"x": x}, index=t_in),
                                       pd.DataFrame({"y": y}, index=t_out), pd.Timedelta(STEP))
    assert got == tuple(want) and len(got[0]) == 3


# ---- regression: reconstruction ----------------------------------------------------------


def test_observation_and_action_responses_are_jax_bytes():
    request = tbuilding.ObservationRequest()
    for device, measurement in (("vav_1", TEMP), ("vav_2", TEMP), ("ghost", TEMP)):
        request.single_observation_requests.add(device_id=device, measurement_name=measurement)
    mapping = {("vav_1", TEMP): 71.5, ("vav_2", TEMP): 295.25, ("boiler", "x"): 1.0}
    got = treg.build_observation_response(request, mapping, TS0 + STEP)
    want = jreg.build_observation_response(_jax(request, jbuilding.ObservationRequest),
                                           mapping, _pd(TS0 + STEP))
    assert _same_bytes(got, want)
    assert treg.observation_mapping(got) == jreg.observation_mapping(want)

    (response,) = _action_responses(1)
    allowed = treg.device_action_tuples(_devices(ttesting, tbuilding))
    jrequest = _jax(response.request, jbuilding.ActionRequest)
    assert _same_bytes(response, jreg.build_action_response(jrequest, _pd(TS0), allowed))
    assert (treg.action_request_to_mapping(response.request, allowed)
            == jreg.action_request_to_mapping(jrequest, allowed))
    prediction = {("vav_1", TEMP): 1.0, (jreg.REWARD_INFO, "boiler", jreg.GAS_RATE): 2.0}
    assert treg.split_prediction(prediction) == jreg.split_prediction(prediction)


class _Occupancy:
    def __init__(self, base):
        self.base = base

    def average_zone_occupancy(self, zone_id, start_time, end_time):
        return {"zone_a": 2.5, "zone_b": 0.25}.get(zone_id, 0.0) + self.base


class _TOccupancy(_Occupancy, tinterfaces.BaseOccupancy):
    pass


class _JOccupancy(_Occupancy, jinterfaces.BaseOccupancy):
    pass


@pytest.mark.parametrize("fahrenheit", [True, False])
def test_reward_infos_from_telemetry_are_jax_bytes(fahrenheit):
    obs = ({("vav_1", TEMP): 72.0, ("vav_2", TEMP): 70.5, ("vav_2", jreg.ZONE_HEAT_SETPOINT): 68.0}
           if fahrenheit else
           {("vav_1", TEMP): 295.5, ("vav_2", TEMP): 294.1, ("vav_2", jreg.ZONE_HEAT_SETPOINT): 293.0})
    window = lambda ts: (294.0, 297.0)
    got = treg.zone_reward_infos(TS0, STEP, obs, _TOccupancy(0.0), window,
                                 _zones(tbuilding), _devices(ttesting, tbuilding), fahrenheit)
    want = jreg.zone_reward_infos(_pd(TS0), pd.Timedelta(STEP), obs, _JOccupancy(0.0), window,
                                  _zones(jbuilding), _devices(jtesting, jbuilding), fahrenheit)
    assert list(got) == list(want) == ["zone_a", "zone_b"]
    assert all(_same_bytes(got[k], want[k]) for k in got)
    for module in (treg, jreg):
        with pytest.raises(ValueError, match="Bad setpoints"):
            module.zone_reward_infos(TS0, STEP, obs, _TOccupancy(0.0), lambda ts: (299.0, 297.0),
                                     [], [], fahrenheit)

    fields = {"boiler": {jreg.GAS_RATE: 30.0, jreg.PUMP_RATE: 4.0},
              "boiler_2": {jreg.GAS_RATE: np.nan, jreg.PUMP_RATE: 4.0},
              "air_handler": {jreg.BLOWER_RATE: 10.0, jreg.AC_RATE: -3.5},
              "half": {jreg.BLOWER_RATE: 1.0}}
    for name in ("boiler_reward_infos", "air_handler_reward_infos"):
        got, want = getattr(treg, name)(fields), getattr(jreg, name)(fields)
        assert list(got) == list(want) and len(got) == 1
        assert all(_same_bytes(got[k], want[k]) for k in got)
    mapping = jreg.reward_info_map(_jax(_reward_infos(1)[0], jreward.RewardInfo))
    numeric = {k: v for k, v in mapping.items() if k[1] != jreg.TIMESTAMP}
    assert treg.group_reward_fields_by_device(numeric) == jreg.group_reward_fields_by_device(numeric)
    assert treg.device_observations(obs, "vav_2") == jreg.device_observations(obs, "vav_2")


def _predict(row):
    """A deterministic surrogate over the whole input row."""
    hod = row["hod_cos_000"] + 0.5 * row["dow_sin_000"]
    act = row.get((treg.ACTION, "boiler", "supply_water_setpoint"), 0.0)
    return {
        ("vav_1", TEMP): row[("vav_1", TEMP)] + 0.25 * hod + 1e-3 * act,
        ("vav_2", TEMP): 0.5 * (row[("vav_1", TEMP)] + row[("vav_2", TEMP)]),
        (treg.REWARD_INFO, "boiler", treg.GAS_RATE): 30.0 + act,
        (treg.REWARD_INFO, "boiler", treg.PUMP_RATE): 40.0 * hod,
        (treg.REWARD_INFO, "air_handler", treg.BLOWER_RATE): 10.0,
        (treg.REWARD_INFO, "air_handler", treg.AC_RATE): -20.0 * hod,
    }


def _surrogates(predict, tdevices, jdevices, tzones, jzones, tinitial, start, **spec):
    common = dict(time_step_sec=300.0, schedule_window=lambda ts: (294.0, 297.0),
                  is_comfort_mode=lambda ts: ts.hour >= 8, **spec)
    port = treg.RegressionBuilding(treg.RegressionBuildingSpec(
        devices=tdevices, zones=tzones, start_timestamp=start, occupancy=_TOccupancy(0.5),
        **common), predict, tinitial)
    jax_ = jreg.RegressionBuilding(jreg.RegressionBuildingSpec(
        devices=jdevices, zones=jzones, start_timestamp=_pd(start), occupancy=_JOccupancy(0.5),
        **common), predict, _jax(tinitial, jbuilding.ObservationResponse))
    return port, jax_


def _drive_both(port, jax_, requests, obs_request, steps):
    """Steps both buildings with the same requests; every proto byte-equal."""
    jobs = _jax(obs_request, jbuilding.ObservationRequest)
    for i in range(steps):
        request = requests[i % len(requests)]
        assert _same_bytes(port.request_action(request),
                           jax_.request_action(_jax(request, jbuilding.ActionRequest)))
        port.wait_time()
        jax_.wait_time()
        assert _same_bytes(port.request_observations(obs_request), jax_.request_observations(jobs))
        assert _same_bytes(port.reward_info, jax_.reward_info), f"step {i}"
        assert _pd(port.current_timestamp) == jax_.current_timestamp
        assert port.num_occupants == jax_.num_occupants
        assert port.is_comfort_mode(port.current_timestamp) == jax_.is_comfort_mode(
            jax_.current_timestamp)


@pytest.mark.parametrize("time_zone,fahrenheit", [("UTC", True), ("US/Pacific", False)])
def test_regression_building_is_jax_for_12_steps(time_zone, fahrenheit):
    initial = ttesting.observation_response(
        {("vav_1", TEMP): 70.0 if fahrenheit else 294.0, ("vav_2", TEMP): 69.0
         if fahrenheit else 293.5}, timestamp=TS0)
    port, jax_ = _surrogates(_predict, _devices(ttesting, tbuilding), _devices(jtesting, jbuilding),
                             _zones(tbuilding), _zones(jbuilding), initial, TS0,
                             time_zone=time_zone, n_hod=2, n_dow=1,
                             sensors_in_fahrenheit=fahrenheit)
    obs_request = tbuilding.ObservationRequest()
    for device in ("vav_1", "vav_2", "ghost"):
        obs_request.single_observation_requests.add(device_id=device, measurement_name=TEMP)
    requests = [a.request for a in _action_responses()]
    _drive_both(port, jax_, requests, obs_request, 12)
    port.reset()
    jax_.reset()
    assert _pd(port.current_timestamp) == jax_.current_timestamp
    assert _same_bytes(port.request_observations(obs_request), jax_.request_observations(
        _jax(obs_request, jbuilding.ObservationRequest)))


# ---- the pipeline ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def recorded_episode(tmp_path_factory):
    """N_STEPS of the port's simulator recorded into proto shards."""
    root = tmp_path_factory.mktemp("episode")
    env = tbe.BuildingEnv(tpresets.two_zone_test_config(), device="cpu")
    building = tha.SimulatedBuilding(env, seed=0)
    host = the.HostEnvironment(building, env, metrics_path=str(root), label="reg")
    host.reset()
    rng = np.random.default_rng(0)
    for _ in range(N_STEPS):
        host.step(rng.uniform(-0.5, 0.5, len(host.action_names)))
    (episode_dir,) = glob.glob(str(root / "reg_*"))
    return env, building, episode_dir


def _frame_episode(regression, reader):
    """Recorded shards -> (inputs, outputs) supervised tables, as
    tests/test_regression_pipeline.py frames them."""
    obs_responses = reader.read_observation_responses()
    action_responses = reader.read_action_responses()
    reward_infos = reader.read_reward_infos()
    assert len(obs_responses) == len(action_responses) == len(reward_infos) == N_STEPS
    obs = regression.observation_sequence(
        obs_responses, regression.feature_tuples(obs_responses[0])).set_index("timestamp")
    act = regression.action_sequence(
        action_responses, regression.action_tuples(action_responses[0])).set_index("timestamp")
    ri = regression.reward_info_sequence(
        reward_infos, regression.reward_info_tuples(reward_infos[0]))
    ri = ri.set_index((regression.REWARD_INFO, "timestamp", "end")).drop(
        columns=[(regression.REWARD_INFO, "timestamp", "start")])
    inputs = obs.join(act, how="inner")
    outputs = obs.drop(columns=[c for c in obs.columns if isinstance(c, str)]).join(
        ri, how="inner")
    return inputs, outputs


def test_pipeline_tables_fit_and_surrogates_are_jax(recorded_episode):
    env, building, episode_dir = recorded_episode
    treader, jreader = trecords.RecordReader(episode_dir), jrecords.RecordReader(episode_dir)
    tin, tout = _frame_episode(treg, treader)
    jin, jout = _frame_episode(jreg, jreader)
    assert_frame_is(tin, jin)
    assert_frame_is(tout, jout)
    idx_in, idx_out = treg.match_sequence_indexes(tin, tout, STEP)
    jidx_in, jidx_out = jreg.match_sequence_indexes(jin, jout, pd.Timedelta(STEP))
    assert (idx_in, idx_out) == (jidx_in, jidx_out)
    assert len(idx_in) == N_STEPS - 1 and all(b - a == STEP for a, b in zip(idx_in, idx_out))

    feature_cols, target_cols = list(tin.columns), list(tout.columns)
    x = tin.loc[idx_in, feature_cols]
    y = tout.loc[idx_out, target_cols]
    np.testing.assert_array_equal(x, jin.loc[jidx_in, feature_cols].to_numpy(float))
    np.testing.assert_array_equal(y, jout.loc[jidx_out, target_cols].to_numpy(float))
    design = np.concatenate([x, np.ones((len(x), 1))], axis=1)
    coef = np.linalg.lstsq(design, y, rcond=None)[0]

    def predict(row):
        vec = np.asarray([float(row.get(c, 0.0)) for c in feature_cols] + [1.0])
        return dict(zip(target_cols, vec @ coef))

    tobs = treader.read_observation_responses()
    port, jax_ = _surrogates(
        predict, treader.read_device_infos(), jreader.read_device_infos(),
        treader.read_zone_infos(), jreader.read_zone_infos(), tobs[0],
        datetime.datetime.fromisoformat(env.config.start_timestamp),
        sensors_in_fahrenheit=False)
    requests = [a.request for a in treader.read_action_responses()[1:11]]
    _drive_both(port, jax_, requests, building.default_observation_request(), 10)
    info = port.reward_info
    assert info.boiler_reward_infos and info.air_handler_reward_infos
    assert len(info.zone_reward_infos) == env.n_zones


# ---- run_command_predictor ---------------------------------------------------------------


def _setpoint_responses(n=40):
    """Two devices; every fifth response repeats the last timestamp."""
    rng = np.random.default_rng(5)
    out, ts = [], TS0
    for i in range(n):
        if i % 5:
            ts = ts + STEP
        setpoints = {("boiler", "supply_water_setpoint"): 320.0 if i % 2 else 350.0,
                     ("air_handler", "supply_air_heating_temperature_setpoint"):
                     rng.uniform(285, 295)}
        if i % 7 == 3:  # a response without the AHU's setpoint
            del setpoints[("air_handler", "supply_air_heating_temperature_setpoint")]
        request = ttesting.action_request(setpoints, timestamp=ts)
        allowed = treg.device_action_tuples(_devices(ttesting, tbuilding))
        out.append(treg.build_action_response(request, ts, allowed))
    return out


def _jax_setpoint_matrix(timeseries):
    """The matrix JAX's RandomForestRunCommandPredictor.fit trains on
    (run_command_predictor.py:90-96)."""
    wide = timeseries.pivot_table(index="timestamp", columns=["device_id", "setpoint_name"],
                                  values="value").ffill()
    return [tuple(c) for c in wide.columns], wide.to_numpy()


def test_run_command_features_and_timeseries_are_jax():
    responses = _setpoint_responses()
    jresponses = [_jax(r, jbuilding.ActionResponse) for r in responses]
    got, want = trcp.get_action_timeseries(responses), jrcp.get_action_timeseries(jresponses)
    want["timestamp"] = want["timestamp"].dt.tz_localize("UTC")
    assert_frame_is(got, want)
    order, matrix = trcp.setpoint_matrix(got)
    jorder, jmatrix = _jax_setpoint_matrix(jrcp.get_action_timeseries(jresponses))
    assert order == jorder
    np.testing.assert_array_equal(matrix, jmatrix)
    for r in responses[:6]:
        np.testing.assert_array_equal(
            trcp.action_request_to_features(r.request, order + [("ghost", "x")]),
            jrcp.action_request_to_features(_jax(r.request, jbuilding.ActionRequest),
                                            order + [("ghost", "x")]))
    assert len(trcp.get_action_timeseries([])) == 0


def test_run_command_predictor_fit_is_jax():
    pytest.importorskip("sklearn")
    responses = _setpoint_responses()
    jresponses = [_jax(r, jbuilding.ActionResponse) for r in responses]
    on = [i % 2 == 0 for i in range(40)]
    port, jax_ = (trcp.RandomForestRunCommandPredictor("boiler"),
                  jrcp.RandomForestRunCommandPredictor("boiler"))
    assert port.fit(trcp.get_action_timeseries(responses), on) == jax_.fit(
        jrcp.get_action_timeseries(jresponses), on)
    rng = np.random.default_rng(8)
    for _ in range(20):
        request = ttesting.action_request(
            {("boiler", "supply_water_setpoint"): rng.uniform(315, 355),
             ("air_handler", "supply_air_heating_temperature_setpoint"): rng.uniform(285, 295)})
        assert _same_bytes(port.predict(request),
                           jax_.predict(_jax(request, jbuilding.ActionRequest)))
    with pytest.raises(RuntimeError, match="not fitted"):
        trcp.RandomForestRunCommandPredictor("boiler").predict(request)


# ---- testing.py --------------------------------------------------------------------------


def test_canned_protos_are_jax_bytes():
    values = {("vav_1", TEMP): 294.5, ("boiler", "supply_water_temperature_sensor"): 333.25}
    setpoints = {("boiler", "supply_water_setpoint"): 340.0, ("ahu", "x"): -1.5}
    for ts in (None, TS0 + STEP):
        jts = None if ts is None else _pd(ts)
        assert _same_bytes(ttesting.single_observation_response("d", "m", 1.5, ts, valid=False),
                           jtesting.single_observation_response("d", "m", 1.5, jts, valid=False))
        assert _same_bytes(ttesting.observation_response(values, ts),
                           jtesting.observation_response(values, jts))
        assert _same_bytes(ttesting.action_request(setpoints, ts),
                           jtesting.action_request(setpoints, jts))
    assert _same_bytes(
        ttesting.device_info("ahu", tbuilding.DeviceInfo.AHU, "z", ["a", "b"], ["c"]),
        jtesting.device_info("ahu", jbuilding.DeviceInfo.AHU, "z", ["a", "b"], ["c"]))
    for kw in ({}, dict(heating_setpoint=293.0, occupancy=3.0, blower_rate=1.0, ac_rate=2.0,
                        gas_rate=3.0, pump_rate=4.0, step_sec=60.0)):
        assert _same_bytes(ttesting.reward_info({"zone_id_1": 295.0, "zone_id_10": 296.0}, **kw),
                           jtesting.reward_info({"zone_id_1": 295.0, "zone_id_10": 296.0}, **kw))
    assert _same_bytes(ttesting.reward_info({}, start=TS0 + STEP),
                       jtesting.reward_info({}, start=_pd(TS0 + STEP)))


def test_simple_building_and_fake_reader_are_jax():
    script = {("vav_1", TEMP): [294.0, 295.0, 296.5], ("boiler", "t"): [330.0]}
    fields = {"boiler": ["supply_water_setpoint"]}
    port, jax_ = ttesting.SimpleBuilding(script, fields), jtesting.SimpleBuilding(script, fields)
    assert [d.SerializeToString() for d in port.devices] == [
        d.SerializeToString(deterministic=True) for d in jax_.devices]
    request = tbuilding.ObservationRequest()
    for key in list(script) + [("ghost", TEMP)]:
        request.single_observation_requests.add(device_id=key[0], measurement_name=key[1])
    action = ttesting.action_request({("boiler", "supply_water_setpoint"): 340.0,
                                      ("boiler", "other"): 1.0})
    for _ in range(4):
        assert _same_bytes(port.request_observations(request), jax_.request_observations(
            _jax(request, jbuilding.ObservationRequest)))
        assert _same_bytes(port.request_action(action),
                           jax_.request_action(_jax(action, jbuilding.ActionRequest)))
        port.wait_time()
        jax_.wait_time()
        assert _pd(port.current_timestamp) == jax_.current_timestamp
    assert port.received_actions == jax_.received_actions and len(port.received_actions) == 4
    assert _same_bytes(port.reward_info, jax_.reward_info)
    assert (port.zones, port.time_step_sec, port.num_occupants, port.is_comfort_mode(TS0)) == (
        jax_.zones, jax_.time_step_sec, jax_.num_occupants, jax_.is_comfort_mode(_pd(TS0)))
    port.reset()
    jax_.reset()
    assert port.received_actions == [] and _pd(port.current_timestamp) == jax_.current_timestamp

    infos = _reward_infos(2)
    reader = ttesting.FakeReader(reward_infos=infos, device_infos=_devices(ttesting, tbuilding),
                                 normalization_info={"a": 1})
    jreader = jtesting.FakeReader(reward_infos=[_jax(r, jreward.RewardInfo) for r in infos],
                                  device_infos=_devices(jtesting, jbuilding),
                                  normalization_info={"a": 1})
    for name in ("read_observation_responses", "read_action_responses", "read_reward_infos",
                 "read_reward_responses", "read_device_infos", "read_zone_infos"):
        got, want = getattr(reader, name)(), getattr(jreader, name)()
        assert [m.SerializeToString() for m in got] == [
            m.SerializeToString(deterministic=True) for m in want]
    assert reader.read_normalization_info() == jreader.read_normalization_info() == {"a": 1}
