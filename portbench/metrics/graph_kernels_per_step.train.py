"""Device operations per train step in the profiled steps, by the
program's own count: each replay's graph nodes (counter
`graphs.kernel_nodes`) over the profiled train steps. The copies the
captured call issues outside its graph are not counted."""

from portbench import program_trace


def read(trace):
    if not trace or trace.get("kind") != "train":
        return None
    nodes = program_trace.graph_nodes(program_trace.snapshot())
    return None if nodes is None else nodes / trace["steps"]
