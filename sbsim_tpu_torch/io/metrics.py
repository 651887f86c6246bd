"""Training/episode metrics: JSONL streams plus an accumulator.

Port of sbsim_tpu/io/metrics.py. It plays the role of the reference's
TensorBoard summary accumulator (environment.py:503, 1099-1159) with a
dependency-free JSONL backend (one JSON object per line) and TensorBoard
export through `torch.utils.tensorboard` when that imports. A step's
scalars, tensors on any one device, reach the host in one copy;
`load_metrics` returns numpy columns (the port does not use pandas).
Under a process group only rank 0 records: the metrics it is given are
already reduced over the ranks (distributed/mesh.py).
"""

from __future__ import annotations

import collections
import json
import os
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from sbsim_tpu_torch.distributed import runtime


class MetricsAccumulator:
    """Accumulates per-step scalars; flushes means every N steps. On a rank
    other than 0 of a process group it records and writes nothing."""

    def __init__(
        self,
        output_path: Optional[str] = None,
        reporting_interval: int = 10,
        tensorboard_dir: Optional[str] = None,
    ):
        self._records = runtime.process_info()["process_index"] == 0
        if not self._records:
            output_path = tensorboard_dir = None
        self._accumulator: Dict[str, List[float]] = collections.defaultdict(list)
        self._reporting_interval = reporting_interval
        self._step = 0
        self._file = None
        if output_path:
            os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
            self._file = open(output_path, "a")
        self._tb_writer = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as exc:
                warnings.warn(
                    f"TensorBoard export is off: torch.utils.tensorboard does not "
                    f"import ({exc}); metrics go to the JSONL file only",
                    RuntimeWarning,
                )
            else:
                self._tb_writer = SummaryWriter(tensorboard_dir)

    def record(self, metrics: Mapping[str, Any]) -> None:
        """Adds one step's scalars (0-d tensors or numbers)."""
        if not self._records:
            return
        tensors = [v for v in metrics.values() if isinstance(v, torch.Tensor)]
        host = iter(
            torch.stack([t.detach().reshape(()).to(torch.float64) for t in tensors])
            .cpu().tolist()
            if tensors else []
        )
        for key, value in metrics.items():
            self._accumulator[key].append(
                next(host) if isinstance(value, torch.Tensor) else float(value)
            )
        self._step += 1
        if self._step % self._reporting_interval == 0:
            self.flush()

    def flush(self) -> None:
        if not self._accumulator:
            return
        means = {
            key: float(np.mean(vals))
            for key, vals in self._accumulator.items()
        }
        if self._file:
            self._file.write(
                json.dumps({"step": self._step, "time": time.time(), **means}) + "\n"
            )
            self._file.flush()
        if self._tb_writer is not None:
            for key, value in means.items():
                self._tb_writer.add_scalar(key, value, global_step=self._step)
            self._tb_writer.flush()
        self._accumulator = collections.defaultdict(list)

    def close(self) -> None:
        self.flush()
        if self._file:
            self._file.close()
            self._file = None
        if self._tb_writer is not None:
            self._tb_writer.close()
            self._tb_writer = None


def load_metrics(path: str) -> Dict[str, np.ndarray]:
    """Loads a JSONL metrics stream as columns: one numpy array per key, a
    row without the key holding NaN."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    keys = list(dict.fromkeys(k for row in rows for k in row))
    return {k: np.asarray([row.get(k, np.nan) for row in rows]) for k in keys}
