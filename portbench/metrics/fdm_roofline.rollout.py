"""The FDM kernel's share of its roofline: the least time the counted work
of the profiled steps could take (bytes at 3.35 TB/s or operations at the
float32 peak, whichever is larger, at the reference's own iteration
counts of the same inputs) over the FDM kernels' device time."""

from portbench import yardstick


def read(trace):
    if not trace or trace.get("kind") != "rollout":
        return None
    sums = yardstick.kernel_sums(trace["window"].kernels)
    us = sum(t for name, (_, t) in sums.items() if "fdm_" in name)
    if us <= 0:
        return None
    return 100.0 * trace["fdm_bound_ms"] * 1e3 / us
