# Frozen copy of sbsim_tpu_torch/graphs.py constant() at commit c9d3945, without its cache.
"""Device constants of the plain SAC update (the reference is never
captured)."""

from __future__ import annotations

import torch


def constant(value, dtype: torch.dtype, device) -> torch.Tensor:
    """`value` as a 0-d tensor on `device`."""
    return torch.tensor(value, dtype=dtype, device=device)
