"""Device operations per batched env step in the profiled calls."""


def read(trace):
    if not trace or trace.get("kind") != "rollout" or not trace["window"].kernels:
        return None
    return len(trace["window"].kernels) / trace["steps"]
