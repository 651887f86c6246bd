"""Reward input/output wire format (reward.proto beside this file): the
same messages and field numbers as sbsim_tpu/proto/reward_pb2.py, on the
port's own wire runtime."""

from sbsim_tpu_torch.proto._message import (
    FLOAT, MAP, MESSAGE, STRING, Field, message_type)
from sbsim_tpu_torch.proto.timestamp_pb2 import Timestamp

_PACKAGE = "smart_buildings.smart_control.proto."

_ZoneRewardInfo = message_type("ZoneRewardInfo", _PACKAGE + "RewardInfo.ZoneRewardInfo", [
    Field("heating_setpoint_temperature", 1, FLOAT),
    Field("cooling_setpoint_temperature", 2, FLOAT),
    Field("zone_air_temperature", 3, FLOAT),
    Field("air_flow_rate_setpoint", 4, FLOAT),
    Field("air_flow_rate", 5, FLOAT),
    Field("average_occupancy", 6, FLOAT),
])

_AirHandlerRewardInfo = message_type(
    "AirHandlerRewardInfo", _PACKAGE + "RewardInfo.AirHandlerRewardInfo", [
        Field("blower_electrical_energy_rate", 1, FLOAT),
        Field("air_conditioning_electrical_energy_rate", 2, FLOAT),
    ])

_BoilerRewardInfo = message_type("BoilerRewardInfo", _PACKAGE + "RewardInfo.BoilerRewardInfo", [
    Field("natural_gas_heating_energy_rate", 1, FLOAT),
    Field("pump_electrical_energy_rate", 2, FLOAT),
])

RewardInfo = message_type("RewardInfo", _PACKAGE + "RewardInfo", [
    Field("start_timestamp", 1, MESSAGE, Timestamp),
    Field("end_timestamp", 2, MESSAGE, Timestamp),
    Field("agent_id", 3, STRING),
    Field("scenario_id", 4, STRING),
    Field("zone_reward_infos", 5, MAP, _ZoneRewardInfo, value_kind=MESSAGE),
    Field("air_handler_reward_infos", 6, MAP, _AirHandlerRewardInfo, value_kind=MESSAGE),
    Field("boiler_reward_infos", 7, MAP, _BoilerRewardInfo, value_kind=MESSAGE),
], nested=[_ZoneRewardInfo, _AirHandlerRewardInfo, _BoilerRewardInfo])

RewardResponse = message_type("RewardResponse", _PACKAGE + "RewardResponse", [
    Field("agent_reward_value", 1, FLOAT),
    Field("productivity_reward", 2, FLOAT),
    Field("electricity_energy_cost", 3, FLOAT),
    Field("natural_gas_energy_cost", 4, FLOAT),
    Field("carbon_emitted", 5, FLOAT),
    Field("carbon_cost", 6, FLOAT),
    Field("productivity_weight", 7, FLOAT),
    Field("energy_cost_weight", 8, FLOAT),
    Field("carbon_emission_weight", 9, FLOAT),
    Field("person_productivity", 10, FLOAT),
    Field("total_occupancy", 11, FLOAT),
    Field("reward_scale", 12, FLOAT),
    Field("reward_shift", 13, FLOAT),
    Field("productivity_regret", 14, FLOAT),
    Field("normalized_productivity_regret", 15, FLOAT),
    Field("normalized_energy_cost", 16, FLOAT),
    Field("normalized_carbon_emission", 17, FLOAT),
    Field("start_timestamp", 18, MESSAGE, Timestamp),
    Field("end_timestamp", 19, MESSAGE, Timestamp),
])
