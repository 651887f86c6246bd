"""Whole env step's share of the card's float32 peak: the FDM solve's
counted operations per env step (the reference's own iterations of the
first episode's sampled steps) times the window's untraced env-steps/s,
over 67 TFLOP/s (the SXM part)."""


def read(trace):
    if not trace or trace.get("kind") != "rollout":
        return None
    return 100.0 * trace["flops_per_env_step"] * trace["env_steps_per_s"] / trace["peak_flops"]
