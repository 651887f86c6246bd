"""Real-building telemetry helpers: imputation and time features.

Port of the part of sbsim_tpu/utils/telemetry.py that the proto host path
reaches:

* `impute_missing_observations`: fills invalid/missing sensor readings from
  the previous response (the sensor-fault tolerance path,
  environment.py:94-250).
* `expand_time_features` / `get_time_feature_names`: phase-shifted sin/cos
  time encodings (regression_building_utils.py:75-126).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sbsim_tpu_torch.proto import building_pb2

HOD_LABEL = "hod"
DOW_LABEL = "dow"


def _key(single) -> Tuple[str, str]:
    req = single.single_observation_request
    return req.device_id, req.measurement_name


def impute_missing_observations(
    current: building_pb2.ObservationResponse,
    previous: Optional[building_pb2.ObservationResponse],
) -> building_pb2.ObservationResponse:
    """Replaces invalid readings with the last valid ones.

    Missing (device, measurement) pairs that existed in the previous response
    are appended; invalid readings are overwritten with the previous value
    when available (environment.py:94-250).
    """
    if previous is None:
        return current
    prev_values: Dict[Tuple[str, str], building_pb2.SingleObservationResponse] = {
        _key(s): s for s in previous.single_observation_responses if s.observation_valid
    }
    out = building_pb2.ObservationResponse()
    out.CopyFrom(current)
    seen = set()
    for single in out.single_observation_responses:
        key = _key(single)
        seen.add(key)
        if not single.observation_valid and key in prev_values:
            single.continuous_value = prev_values[key].continuous_value
            single.observation_valid = True
    for key, prev_single in prev_values.items():
        if key not in seen:
            out.single_observation_responses.add().CopyFrom(prev_single)
    return out


def get_time_feature_names(n: int, label: str = HOD_LABEL) -> List[str]:
    """['<label>_cos_000', ..., '<label>_sin_000', ...]"""
    return [f"{label}_cos_%03d" % i for i in range(n)] + [
        f"{label}_sin_%03d" % i for i in range(n)]


def expand_time_features(n: int, rad: float, label: str = HOD_LABEL) -> Dict[str, float]:
    """2n phase-shifted time signals (regression_building_utils.py:97-126)."""
    phase = rad + np.arange(n) / n * 2.0 * np.pi
    names = get_time_feature_names(n, label)
    return dict(zip(names, np.concatenate([np.cos(phase), np.sin(phase)])))
