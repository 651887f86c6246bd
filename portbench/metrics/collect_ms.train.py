"""Milliseconds of the learn=False side of the captured train step (the
collect step with the policy acting, no update), called alone after the
window, CUDA events over many calls on the cell's state."""


def read(trace):
    if not trace or trace.get("kind") != "train":
        return None
    return trace["collect_ms"]
