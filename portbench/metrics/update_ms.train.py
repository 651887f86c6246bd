"""Milliseconds of the SAC update: the learn=True side of the captured
train step less its learn=False side, each timed alone by CUDA events."""


def read(trace):
    if not trace or trace.get("kind") != "train":
        return None
    return trace["update_ms"]
