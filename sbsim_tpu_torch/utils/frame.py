"""A small column table in place of the DataFrames of the offline path.

The JAX package frames recorded telemetry with pandas, which the card's
machine does not have. `Frame` holds exactly what that code reads off a
DataFrame, with pandas' semantics for each:

* `columns`: a list of keys (strings or tuples), in pandas' order;
* `index`: a list of row labels (UTC-aware datetimes) or a range;
* `values`: a float64 (rows, columns) array, NaN where pandas has NaN.
  Columns of other values (timestamps, strings) are kept as lists in
  `objects`; their entries of `values` are NaN and a missing entry is
  None.

No other DataFrame behaviour is carried.
"""

from __future__ import annotations

import numbers
import warnings
from typing import Any, Dict, Hashable, Iterable, List, Mapping, Optional, Sequence

import numpy as np

Key = Hashable


def _is_number(value) -> bool:
    return isinstance(value, (numbers.Real, np.number, np.bool_))


class Frame:
    """Rows by columns; see the module docstring."""

    def __init__(
        self,
        values: np.ndarray,
        columns: Sequence[Key],
        index: Optional[Sequence] = None,
        objects: Optional[Mapping[Key, List[Any]]] = None,
    ):
        self.values = np.asarray(values, np.float64)
        self.columns = list(columns)
        if self.values.ndim != 2 or self.values.shape[1] != len(self.columns):
            raise ValueError(f"values of shape {self.values.shape} for {len(self.columns)} columns")
        n = self.values.shape[0]
        self.index = range(n) if index is None else index
        if len(self.index) != n:
            raise ValueError(f"index of {len(self.index)} labels for {n} rows")
        self.objects = {k: list(v) for k, v in (objects or {}).items()}
        if set(self.objects) - set(self.columns):
            raise ValueError(f"object columns {set(self.objects) - set(self.columns)} not in columns")
        self._position = {k: i for i, k in enumerate(self.columns)}

    # ---- construction -------------------------------------------------

    @classmethod
    def from_rows(
        cls,
        rows: Iterable[Mapping[Key, Any]],
        columns: Optional[Sequence[Key]] = None,
        index: Optional[Sequence] = None,
    ) -> "Frame":
        """pd.DataFrame(rows, columns=columns, index=index): a missing key
        is NaN (None in an object column), keys outside `columns` are
        dropped; without `columns`, keys in first-seen order over the rows."""
        rows = list(rows)
        if columns is None:
            columns = list(dict.fromkeys(k for row in rows for k in row))
        return cls.from_columns({k: [row.get(k) for row in rows] for k in columns},
                                index=index, n_rows=len(rows))

    @classmethod
    def from_columns(
        cls,
        data: Mapping[Key, Sequence[Any]],
        index: Optional[Sequence] = None,
        n_rows: Optional[int] = None,
    ) -> "Frame":
        """pd.DataFrame(data, index=index) of equal-length columns; a column
        of numbers (None or NaN where missing) is a float column, any other
        an object column."""
        columns = list(data)
        if n_rows is None:
            n_rows = len(next(iter(data.values()))) if data else (
                0 if index is None else len(index))
        values = np.full((n_rows, len(columns)), np.nan)
        objects = {}
        for j, key in enumerate(columns):
            col = list(data[key])
            if len(col) != n_rows:
                raise ValueError(f"column {key!r} holds {len(col)} values for {n_rows} rows")
            if all(v is None or _is_number(v) for v in col):
                values[:, j] = [np.nan if v is None else float(v) for v in col]
            else:
                objects[key] = [None if isinstance(v, float) and np.isnan(v) else v
                                for v in col]
        return cls(values, columns, index, objects)

    # ---- access --------------------------------------------------------

    def __len__(self) -> int:
        return self.values.shape[0]

    def __getitem__(self, key):
        """A column (a float64 array, or a list for an object column), or,
        for a list of keys, a Frame of those columns."""
        if isinstance(key, list):
            return self._select(key)
        if key in self.objects:
            return list(self.objects[key])
        return self.values[:, self._position[key]].copy()

    def __setitem__(self, key, value) -> None:
        """Sets a float column from a number (every row) or a sequence;
        a new key is appended as the last column."""
        col = np.broadcast_to(np.asarray(value, np.float64), (len(self),))
        if key not in self._position:
            self.columns.append(key)
            self._position[key] = len(self.columns) - 1
            self.values = np.concatenate([self.values, col[:, None]], axis=1)
        else:
            self.values[:, self._position[key]] = col
            self.objects.pop(key, None)

    def _select(self, keys: Sequence[Key], rows: Optional[Sequence[int]] = None) -> "Frame":
        """The columns `keys` of the rows at positions `rows` (all rows when
        None)."""
        pos = [self._position[k] for k in keys]
        if rows is None:
            values, index = self.values[:, pos], self.index
            objects = {k: self.objects[k] for k in keys if k in self.objects}
        else:
            rows = list(rows)
            values, index = self.values[rows][:, pos], [self.index[i] for i in rows]
            objects = {k: [self.objects[k][i] for i in rows] for k in keys if k in self.objects}
        return Frame(values, keys, index, objects)

    def copy(self) -> "Frame":
        return self._select(self.columns)

    @property
    def loc(self) -> "_Loc":
        """`frame.loc[rows, cols]`: the float values of those row labels and
        columns as a (rows, cols) array (pandas' `.loc[...].to_numpy(float)`)."""
        return _Loc(self)

    def to_numpy(self) -> np.ndarray:
        if self.objects:
            raise ValueError(f"object columns {list(self.objects)} are not numbers")
        return self.values.copy()

    def _row_positions(self, labels: Sequence) -> List[int]:
        where = {label: i for i, label in enumerate(self.index)}
        if len(where) != len(self):
            raise ValueError("the index holds repeated labels")
        return [where[label] for label in labels]

    # ---- reshaping -----------------------------------------------------

    def set_index(self, key: Key) -> "Frame":
        """The column `key` as the index, and no longer a column."""
        index = list(self[key])
        out = self._select([k for k in self.columns if k != key])
        out.index = index
        return out

    def drop(self, columns: Sequence[Key]) -> "Frame":
        missing = [k for k in columns if k not in self._position]
        if missing:
            raise KeyError(f"{missing} not found in columns")
        gone = set(columns)
        return self._select([k for k in self.columns if k not in gone])

    def join(self, other: "Frame", how: str = "inner") -> "Frame":
        """Inner join on the index, in the left frame's row order; the
        columns of both, the left's first."""
        if how != "inner":
            raise ValueError(f"only the inner join is carried; got {how!r}")
        overlap = set(self.columns) & set(other.columns)
        if overlap:
            raise ValueError(f"columns overlap: {sorted(map(str, overlap))}")
        right = {label: i for i, label in enumerate(other.index)}
        if len(right) != len(other):
            raise ValueError("the right index holds repeated labels")
        left_rows = [i for i, label in enumerate(self.index) if label in right]
        right_rows = [right[self.index[i]] for i in left_rows]
        a, b = self._select(self.columns, left_rows), other._select(other.columns, right_rows)
        return concat([a, b])

    def dropna(self) -> "Frame":
        """The rows with no NaN (no None in an object column)."""
        keep = ~np.isnan(np.delete(self.values, [self._position[k] for k in self.objects],
                                   axis=1)).any(axis=1)
        for col in self.objects.values():
            keep &= np.asarray([v is not None for v in col], bool)
        return self._select(self.columns, list(np.flatnonzero(keep)))

    def ffill(self) -> "Frame":
        """Each NaN of a float column takes the last value above it."""
        out = self.copy()
        v = out.values
        for i in range(1, len(out)):
            gap = np.isnan(v[i])
            v[i, gap] = v[i - 1, gap]
        return out

    def pivot_table(self, index: Key, columns: Sequence[Key], values: Key) -> "Frame":
        """pandas' pivot_table with its defaults: the mean of the non-NaN
        `values` of each (index, columns) group, the groups with none
        dropped; the index and the columns (tuples of the `columns` keys)
        sorted."""
        labels = self[index]
        keys = list(zip(*(self[c] for c in columns)))
        vals = self[values]
        groups: Dict[Any, Dict[tuple, List[float]]] = {}
        for label, key, v in zip(labels, keys, vals):
            if not np.isnan(v):
                groups.setdefault(label, {}).setdefault(key, []).append(float(v))
        rows = sorted(groups)
        cols = sorted({k for g in groups.values() for k in g})
        where = {k: j for j, k in enumerate(cols)}
        out = np.full((len(rows), len(cols)), np.nan)
        for i, label in enumerate(rows):
            for key, vs in groups[label].items():
                out[i, where[key]] = _kahan_sum(vs) / len(vs)
        return Frame(out, cols, rows)

    # ---- row statistics (pandas' skipna defaults) ----------------------

    def _row_stat(self, fn, axis: int, **kw) -> np.ndarray:
        if axis != 1:
            raise ValueError("only row statistics (axis=1) are carried")
        if self.objects:
            raise ValueError(f"object columns {list(self.objects)} are not numbers")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN rows give NaN
            return fn(self.values, axis=1, **kw)

    def mean(self, axis: int = 1) -> np.ndarray:
        return self._row_stat(np.nanmean, axis)

    def std(self, axis: int = 1) -> np.ndarray:
        return self._row_stat(np.nanstd, axis, ddof=1)

    def median(self, axis: int = 1) -> np.ndarray:
        return self._row_stat(np.nanmedian, axis)


def _kahan_sum(values: Sequence[float]) -> float:
    """The compensated sum of pandas' group mean (groupby.pyx group_mean),
    so that a group of three or more readings averages bitwise as there."""
    total = compensation = 0.0
    for v in values:
        y = v - compensation
        t = total + y
        compensation = t - total - y
        if compensation != compensation:  # an infinite value: keep it infinite
            compensation = 0.0
        total = t
    return total


class _Loc:
    def __init__(self, frame: Frame):
        self._frame = frame

    def __getitem__(self, rows_cols) -> np.ndarray:
        rows, cols = rows_cols
        f = self._frame
        return f._select(list(cols), f._row_positions(rows)).to_numpy()


def concat(frames: Sequence[Frame]) -> Frame:
    """pd.concat(frames, axis=1) of frames on the same index."""
    first = frames[0]
    for f in frames[1:]:
        if list(f.index) != list(first.index):
            raise ValueError("concat takes frames on the same index")
    columns = [k for f in frames for k in f.columns]
    if len(set(columns)) != len(columns):
        raise ValueError("concat of frames with a column in common")
    objects = {k: v for f in frames for k, v in f.objects.items()}
    return Frame(np.concatenate([f.values for f in frames], axis=1), columns, first.index,
                 objects)
