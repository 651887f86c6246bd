"""Cross-block barriers per FDM solve that no iteration takes, in the
profiled calls, by the program's own counts: the barriers each env's solve
crossed between the thread blocks of its cluster (counter `fdm.barriers`,
the call's last step) less that step's iterations (counter
`fdm.iterations`, one barrier each), over the solves counted (`env.steps`).
On a fixed design it is the solve's fixed count (the swap rounds, the
decision groups and the emitted J(x_f)), whatever the inputs' iterations.
A solve that fits one block crosses none, and a program without the
counter keeps none: both read None."""

from portbench import program_trace


def read(trace):
    if not trace or trace.get("kind") != "rollout":
        return None
    counters = program_trace.snapshot().get("counters", {})
    if not counters.get("env.steps") or "fdm.barriers" not in counters:
        return None
    return (counters["fdm.barriers"] - counters.get("fdm.iterations", 0.0)) / counters["env.steps"]
