"""On/off run-command prediction from continuous setpoints.

SAC emits continuous setpoints only, but real devices also need discrete
run commands; the reference trains a random-forest classifier on recorded
action timeseries to infer On/Off from the continuous setpoints
(run_command_predictor.py:53-265). Port of
sbsim_tpu/utils/run_command_predictor.py with `Frame` in place of pandas;
the classifier is scikit-learn's, imported when a predictor is fitted.
"""

from __future__ import annotations

import abc
from typing import List, Sequence, Tuple

import numpy as np

from sbsim_tpu_torch.proto import building_pb2
from sbsim_tpu_torch.utils.conversions import UTC
from sbsim_tpu_torch.utils.frame import Frame


class BaseRunCommandPredictor(abc.ABC):
    @abc.abstractmethod
    def predict(
        self, action_request: building_pb2.ActionRequest
    ) -> building_pb2.ActionRequest:
        """Returns the request augmented with predicted run commands."""


def action_request_to_features(
    action_request: building_pb2.ActionRequest,
    setpoint_order: Sequence[Tuple[str, str]],
) -> np.ndarray:
    """Flattens continuous setpoints into a feature vector
    (run_command_predictor.py:78-99)."""
    values = {
        (r.device_id, r.setpoint_name): r.continuous_value
        for r in action_request.single_action_requests
    }
    return np.asarray(
        [values.get(key, 0.0) for key in setpoint_order], np.float64
    )


def get_action_timeseries(
    action_responses: Sequence[building_pb2.ActionResponse],
) -> Frame:
    """Recorded ActionResponses -> long Frame of setpoints: timestamp (UTC),
    device_id, setpoint_name, value, response_type
    (run_command_predictor.py:153-210)."""
    rows = []
    for response in action_responses:
        ts = response.timestamp.ToDatetime(tzinfo=UTC)
        for single in response.single_action_responses:
            rows.append(
                {
                    "timestamp": ts,
                    "device_id": single.request.device_id,
                    "setpoint_name": single.request.setpoint_name,
                    "value": single.request.continuous_value,
                    "response_type": single.response_type,
                }
            )
    return Frame.from_rows(rows)


def setpoint_matrix(action_timeseries: Frame) -> Tuple[List[Tuple[str, str]], np.ndarray]:
    """The wide pivot a predictor is fitted on: (setpoint order, matrix of
    one row per timestamp), the mean of each timestamp's values, forward
    filled."""
    wide = action_timeseries.pivot_table(
        index="timestamp",
        columns=["device_id", "setpoint_name"],
        values="value",
    ).ffill()
    return [tuple(c) for c in wide.columns], wide.to_numpy()


class RandomForestRunCommandPredictor(BaseRunCommandPredictor):
    """Random-forest On/Off classifier per commanded device."""

    def __init__(
        self,
        target_device_id: str,
        target_setpoint_name: str = "run_command",
        n_estimators: int = 20,
        seed: int = 37,
    ):
        self._target_device_id = target_device_id
        self._target_setpoint_name = target_setpoint_name
        self._n_estimators = n_estimators
        self._seed = seed
        self._model = None
        self._setpoint_order: List[Tuple[str, str]] = []

    def fit(
        self,
        action_timeseries: Frame,
        run_command_values: Sequence[bool],
    ) -> float:
        """Trains on a wide pivot of recorded setpoints; returns train
        accuracy. Needs scikit-learn."""
        from sklearn.ensemble import RandomForestClassifier

        self._setpoint_order, x = setpoint_matrix(action_timeseries)
        y = np.asarray(run_command_values, bool)[: len(x)]
        x = x[: len(y)]
        self._model = RandomForestClassifier(
            n_estimators=self._n_estimators, random_state=self._seed
        )
        self._model.fit(x, y)
        return float(self._model.score(x, y))

    def predict(
        self, action_request: building_pb2.ActionRequest
    ) -> building_pb2.ActionRequest:
        if self._model is None:
            raise RuntimeError("Predictor not fitted")
        features = action_request_to_features(
            action_request, self._setpoint_order
        )
        on = bool(self._model.predict(features[None, :])[0])
        out = building_pb2.ActionRequest()
        out.CopyFrom(action_request)
        out.single_action_requests.add(
            device_id=self._target_device_id,
            setpoint_name=self._target_setpoint_name,
            integer_value=int(on),
        )
        return out
