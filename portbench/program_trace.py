"""The program's own spans and counters (sbsim_tpu_torch.utils.profiling),
as the per-layer readers take them: the last stretch of tracing, which a
`--trace 1` run's profiled calls make (tracing is on while a profiler
records). A program without the registry gives an empty snapshot."""

from __future__ import annotations

from typing import Any, Dict, Optional


def snapshot() -> Dict[str, Any]:
    """The program's `profiling.snapshot()`, or {} where it has none."""
    try:
        from sbsim_tpu_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "snapshot", None)
    return read() if read is not None else {}


def graph_nodes(snap: Dict[str, Any]) -> Optional[float]:
    """Device operations the captured calls' graphs ran: each replay's
    kernel, memcpy and memset nodes (counter `graphs.kernel_nodes`)."""
    return snap.get("counters", {}).get("graphs.kernel_nodes")
