"""FDM iterations per env step in the profiled calls, by the program's own
count: the returned states' iterations (counter `fdm.iterations`) over the
env steps they cover (`env.steps`). It follows the profiled calls' inputs
(the time of day where the timed window ended), so one run's reading moves
with them as the reference's iterations on the same inputs do."""

from portbench import program_trace


def read(trace):
    if not trace or trace.get("kind") != "rollout":
        return None
    counters = program_trace.snapshot().get("counters", {})
    if not counters.get("env.steps") or "fdm.iterations" not in counters:
        return None
    return counters["fdm.iterations"] / counters["env.steps"]
