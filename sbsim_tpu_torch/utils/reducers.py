"""Observation-sequence reducers for offline feature pipelines.

Port of sbsim_tpu/utils/reducers.py on `Frame` in place of DataFrames:
equivalents of the reference reducer toolkit (reducer.py:64-191,
histogram_reducer.py:204-471) that reduce a wide observation frame whose
columns are (device, measurement) tuples into compressed features, and
expand back to approximate per-device values.

The device-side histogram features used inside the RL observation vector live
in envs/observation.py; this module serves host-side analysis and
real-building dataset preparation.
"""

from __future__ import annotations

import abc
import collections
from typing import Dict, List, Mapping, Sequence

import numpy as np

from sbsim_tpu_torch.utils.frame import Frame, concat

HistogramParameters = Mapping[str, Sequence[float]]


def _measurement(col) -> str:
    return col[-1] if isinstance(col, tuple) else col


class BaseReducedSequence(abc.ABC):
    reduced_sequence: Frame

    @abc.abstractmethod
    def expand(self) -> Frame:
        """Approximately reconstructs the original wide sequence."""


class BaseReducer(abc.ABC):
    @abc.abstractmethod
    def reduce(self, observation_sequence: Frame) -> BaseReducedSequence:
        """Compresses a wide observation frame."""


class IdentityReducer(BaseReducer):
    """Passthrough (reducer.py:80-95)."""

    class _Reduced(BaseReducedSequence):
        def __init__(self, frame: Frame):
            self.reduced_sequence = frame

        def expand(self) -> Frame:
            return self.reduced_sequence

    def reduce(self, observation_sequence: Frame):
        return self._Reduced(observation_sequence)


class StatsReducer(BaseReducer):
    """Per-measurement summary stats across devices (reducer.py:96-191),
    with pandas' defaults: NaN skipped, `std` with ddof=1."""

    def __init__(self, stats: Sequence[str] = ("mean", "std", "median")):
        self._stats = tuple(stats)

    class _Reduced(BaseReducedSequence):
        def __init__(self, frame: Frame, columns):
            self.reduced_sequence = frame
            self._columns = columns

        def expand(self) -> Frame:
            # Lossy: every device gets its measurement's mean back.
            return Frame.from_columns(
                {col: self.reduced_sequence[(col[1], "mean")] for col in self._columns},
                index=self.reduced_sequence.index,
            )

    def reduce(self, observation_sequence: Frame):
        groups: Dict[str, List] = collections.defaultdict(list)
        for col in observation_sequence.columns:
            groups[_measurement(col)].append(col)
        data = {}
        for measurement, cols in groups.items():
            block = observation_sequence[cols]
            for stat in self._stats:
                data[(measurement, stat)] = getattr(block, stat)(axis=1)
        return self._Reduced(
            Frame.from_columns(data, index=observation_sequence.index,
                               n_rows=len(observation_sequence)),
            list(observation_sequence.columns),
        )


def clipped_histogram(
    measurements: np.ndarray, bins: Sequence[float], clip: bool = True
) -> np.ndarray:
    """Counts per bin edge with min/max clipping; values equal to the top
    edge land in the final bin (histogram_reducer.py:136-148)."""
    edges = np.asarray(bins, float)
    v = np.asarray(measurements, float)
    if clip:
        v = np.clip(v, edges.min(), edges.max())
    idx = (v[:, None] >= edges[None, 1:]).sum(axis=1)
    return np.bincount(idx, minlength=len(edges)).astype(np.float32)


def assign_devices_to_bins(
    values: Mapping[str, float], bins: Sequence[float]
) -> Dict[int, List[str]]:
    """bin index -> device ids (histogram_reducer.py:84-110)."""
    edges = np.asarray(bins, float)
    assignment: Dict[int, List[str]] = collections.defaultdict(list)
    for device, v in values.items():
        idx = int((np.clip(v, edges.min(), edges.max()) >= edges[1:]).sum())
        assignment[idx].append(device)
    return assignment


class HistogramReducer(BaseReducer):
    """Compresses per-device measurements into per-bin counts
    (histogram_reducer.py:204-471).

    Columns whose measurement appears in histogram_parameters collapse into
    len(bins) count features named (measurement, 'h_<edge>'); all other
    columns pass through. The reduced frame holds the passthrough columns,
    then the histogram columns, as pd.concat(..., axis=1) orders them.
    """

    def __init__(
        self,
        histogram_parameters: HistogramParameters,
        normalize_reduce: bool = False,
    ):
        self._histogram_parameters = dict(histogram_parameters)
        self._normalize_reduce = normalize_reduce

    @property
    def histogram_parameters(self) -> HistogramParameters:
        return self._histogram_parameters

    class _Reduced(BaseReducedSequence):
        def __init__(self, reduced, passthrough, assignments, params):
            self.reduced_sequence = reduced
            self._passthrough = passthrough
            self._assignments = assignments
            self._params = params

        def expand(self) -> Frame:
            """Lossy reconstruction: each device takes its assigned bin's
            edge value (histogram_reducer.py:112-134)."""
            out = self._passthrough.copy()
            for measurement, assignment in self._assignments.items():
                edges = np.asarray(self._params[measurement], float)
                for bin_idx, devices in assignment.items():
                    for device in devices:
                        out[(device, measurement)] = edges[min(bin_idx, len(edges) - 1)]
            return out

    def reduce(self, observation_sequence: Frame):
        hist_cols: Dict[str, List] = collections.defaultdict(list)
        passthrough_cols = []
        for col in observation_sequence.columns:
            measurement = _measurement(col)
            if measurement in self._histogram_parameters:
                hist_cols[measurement].append(col)
            else:
                passthrough_cols.append(col)
        passthrough = observation_sequence[passthrough_cols]

        pieces = [passthrough]
        assignments: Dict[str, Dict[int, List[str]]] = {}
        for measurement, cols in hist_cols.items():
            edges = self._histogram_parameters[measurement]
            block = observation_sequence[cols].values
            counts = np.stack([clipped_histogram(row, edges) for row in block])
            if self._normalize_reduce:
                counts = counts / counts.sum(axis=1, keepdims=True)
            columns = [(measurement, "h_%.2f" % e) for e in edges]
            pieces.append(Frame(counts, columns, observation_sequence.index))
            assignments[measurement] = assign_devices_to_bins(
                {(c[0] if isinstance(c, tuple) else c): v for c, v in zip(cols, block[-1])},
                edges,
            )
        reduced = concat(pieces)
        return self._Reduced(reduced, passthrough, assignments, self._histogram_parameters)
