"""Whole training iteration's share of the card's float32 peak: the collect
step's FDM solve (the reference's iterations) and policy, and the SAC
update's matrix products (forward and backward of the actor, both critics
and the target critics), per iteration, times the window's untraced
iterations per second, over 67 TFLOP/s."""


def read(trace):
    if not trace or trace.get("kind") != "train":
        return None
    return 100.0 * trace["step_flops"] * trace["steps_per_s"] / trace["peak_flops"]
