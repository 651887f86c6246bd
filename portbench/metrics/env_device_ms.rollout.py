"""Device milliseconds per batched env step of every operation but the FDM
solve's (HVAC, occupancy, convection, observation, reward, and the
captured call's copies), summed from the profiled calls."""

from portbench import yardstick


def read(trace):
    if not trace or trace.get("kind") != "rollout" or not trace["window"].kernels:
        return None
    sums = yardstick.kernel_sums(trace["window"].kernels)
    us = sum(t for name, (_, t) in sums.items() if "fdm_" not in name)
    return us / 1e3 / trace["steps"]
