"""Per-plan convection schedule cache.

Copy of sbsim_tpu/scenario/conv_cache.py over the port's own copy of
data/conv_schedules.json. The searched (rounds, seed) of a floor plan is
keyed by a content fingerprint of its raster, so the same plan array always
maps to the same schedule in both packages. Unlike the JAX package, a
missing cache file raises on lookup instead of silently meaning "no plan
searched"; `record` writes an entry into a given cache file.
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


def record(
    plan: np.ndarray,
    rounds: int,
    seed: int,
    worst_zone_ks: float,
    worst_zone_dmean_k: float,
    plan_desc: str,
    source: str,
    path: Optional[str] = None,
) -> str:
    """Writes or updates the cache entry of this plan in the cache file at
    `path` (the packaged cache by default; a file that does not exist yet
    starts empty); returns the entry's key."""
    path = path or _CACHE_PATH
    cache = _load(path) if os.path.exists(path) else {}
    key = plan_fingerprint(plan)
    cache[key] = {
        "rounds": int(rounds),
        "seed": int(seed),
        "worst_zone_ks": float(worst_zone_ks),
        "worst_zone_dmean_K": float(worst_zone_dmean_k),
        "plan_desc": plan_desc,
        "source": source,
    }
    with open(path, "w") as f:
        json.dump(cache, f, indent=2, sort_keys=True)
        f.write("\n")
    return key
