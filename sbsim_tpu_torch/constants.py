"""Physical and unit-conversion constants.

Parity source: reference smart_control/utils/constants.py:20-48 and
smart_control/simulator/constants.py:20-128 (values are standard physical
constants and public unit conversions).
"""

from typing import Final

# --------- Thermal constants ---------------
AIR_HEAT_CAPACITY: Final[float] = 1006.0  # J/kg/K, standard atmosphere
WATER_HEAT_CAPACITY: Final[float] = 4180.0  # J/kg/K
WATER_VAPOR_HEAT_CAPACITY: Final[float] = 1863.8  # J/kg/K

# --------- Energy constants ---------------
BTU_PER_KWH: Final[float] = 3412.4
JOULES_PER_KWH: Final[float] = 3.6e6
JOULES_PER_BTU: Final[float] = 1055.06
W_PER_KW: Final[float] = 1000.0
WATTS_PER_BTU_HR: Final[float] = 0.29307107
HZ_PERCENT: Final[float] = 100.0 / 60.0
WATTS_PER_HORSEPOWER: Final[float] = 746.0

# Natural gas energy conversion (kWh per 1000 cubic feet of natural gas).
KWH_PER_KFT3_GAS: Final[float] = 293.07107
# Natural gas CO2 emission (kg per 1000 cubic feet).
GAS_CO2: Final[float] = 53.12

WATER_DENSITY: Final[float] = 1000.0  # kg/m3
GRAVITY: Final[float] = 9.8  # m/s2

# --------- Floor-plan encoding (file input schema) ---------------
# Raster floor plans encode: 0 = interior space, 1 = wall, 2 = outside air.
# (reference smart_control/simulator/constants.py:34, 50, 92)
INTERIOR_SPACE_VALUE: Final[int] = 0
WALL_VALUE: Final[int] = 1
EXTERIOR_SPACE_VALUE: Final[int] = 2

# How many control-volume layers of wall to treat as "exterior wall".
# (reference smart_control/simulator/constants.py:71)
EXPAND_EXTERIOR_WALLS_BY_CV_AMOUNT: Final[int] = 2

EXTERIOR_SPACE_NAME: Final[str] = "exterior_space"
INTERIOR_WALL_NAME: Final[str] = "interior_wall"
ROOM_PREFIX: Final[str] = "room"

# --------- Record-file naming convention ---------------
NORMALIZATION_FILENAME: Final[str] = "normalization_info"
OBSERVATION_RESPONSE_FILE_PREFIX: Final[str] = "observation_response"
ACTION_RESPONSE_FILE_PREFIX: Final[str] = "action_response"
REWARD_INFO_PREFIX: Final[str] = "reward_info"
REWARD_RESPONSE_PREFIX: Final[str] = "reward_response"
DEVICE_INFO_PREFIX: Final[str] = "device_info"
ZONE_INFO_PREFIX: Final[str] = "zone_info"
