"""Per-plan convection schedule cache.

Copy of sbsim_tpu/scenario/conv_cache.py over the port's own copy of
data/conv_schedules.json. The searched (rounds, seed) of a floor plan is
keyed by a content fingerprint of its raster, so the same plan array always
maps to the same schedule in both packages. Unlike the JAX package, a
missing cache file raises instead of silently meaning "no plan searched".
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

import numpy as np

_CACHE_PATH = os.path.join(
    os.path.dirname(__file__), "..", "data", "conv_schedules.json"
)


def plan_fingerprint(plan: np.ndarray) -> str:
    """Content hash of a floor-plan raster (shape + cell codes)."""
    arr = np.ascontiguousarray(np.asarray(plan, np.float64))
    h = hashlib.sha256()
    h.update(np.asarray(arr.shape, np.int64).tobytes())
    h.update(arr.tobytes())
    return h.hexdigest()[:16]


def _load(path: Optional[str] = None) -> Dict[str, Any]:
    with open(path or _CACHE_PATH) as f:
        return json.load(f)


def lookup(
    plan: np.ndarray, path: Optional[str] = None
) -> Optional[Dict[str, Any]]:
    """Searched schedule entry for this plan, or None if never searched.

    An entry carries {"rounds", "seed", "worst_zone_ks",
    "worst_zone_dmean_K", "plan_desc", "source"}; rounds/seed feed
    ConvectionConfig directly (the search expresses winners as seeded
    selections, not explicit triples).
    """
    return _load(path).get(plan_fingerprint(plan))
