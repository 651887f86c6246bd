"""CPU tests of the per-layer readers that take the program's own spans and
counters (`program_trace`): each on a synthetic snapshot, None on a trace
of the other kind, on no trace, and where the program has no registry or
an empty one.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import pytest

from portbench import harness, program_trace

ROLLOUT = {"kind": "rollout", "steps": 24}
TRAIN = {"kind": "train", "steps": 20}


SNAPSHOT = {
    "spans": {},
    "counters": {"graphs.kernel_nodes": 24 * 1026,
                 "fdm.iterations": 9.5 * 2048 * 24, "env.steps": 2048 * 24},
    "records": [],
}

EXPECTED = {
    "fdm_iters_per_step.rollout": (ROLLOUT, 9.5),
    "graph_kernels_per_step.rollout": (ROLLOUT, 1026.0),
    "graph_kernels_per_step.train": (TRAIN, 24 * 1026.0 / 20),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_snapshot(name, monkeypatch):
    monkeypatch.setattr(program_trace, "snapshot", lambda: SNAPSHOT)
    trace, want = EXPECTED[name]
    read = harness.metric_reader(name)
    assert read(trace) == pytest.approx(want)
    other = TRAIN if trace is ROLLOUT else ROLLOUT
    assert read(other) is None and read(None) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_in_an_empty_program(name, monkeypatch):
    monkeypatch.setattr(program_trace, "snapshot", lambda: {})
    trace, _ = EXPECTED[name]
    assert harness.metric_reader(name)(trace) is None


def test_a_program_without_the_registry_gives_an_empty_snapshot(monkeypatch):
    from sbsim_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert program_trace.snapshot() == {}


def test_every_new_reader_is_declared_for_its_cells():
    bench = harness.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name, (trace, _) in EXPECTED.items():
        m = declared[name]
        cells = [w["name"] for w in bench["workloads"]
                 if harness.cell(w["name"], bench).traffic["kind"] == trace["kind"]]
        assert m["workloads"] == cells and m["source"] == "device_trace"
