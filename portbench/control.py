"""Reads what the comparison gives for the controls and the planted faults
of a cell, at the cell's own size, on the card: the readings its limits
are set from (PERF.md). The benchmark's own runs never run this.

    python3 portbench/control.py --workload office12.rollout --seeds 101,102,103 \\
        --what control,unchanged,half_batch,altered --seconds 3

One JSON line per seed and reading: {"workload", "seed", "what",
"compared": {name: value}}. `program` reads the program itself, as a run
does.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(c, what: str, seed: int, seconds: float):
    import torch

    from portbench import faults, inputs
    from portbench.drivers import rollout, train

    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    table = inputs.schedule_table(c.config, c.traffic)
    if what == "control_env" and c.traffic["kind"] == "train":
        # The train cell's env step (its configuration, n_envs, solver) with
        # the bfloat16 reference in the program's place, through the rollout
        # generator: the upper reading of the env-step numbers.
        traffic = {"kind": "rollout", "batch": c.traffic["n_envs"], "steps_per_call": 1,
                   "solver": c.traffic["solver"], "schedule_policy": c.traffic["schedule_policy"]}
        c = dataclasses.replace(c, traffic=traffic)
        what = "control"
    if c.traffic["kind"] == "rollout":
        if what == "control":
            system = faults.ReferenceRollout(c.config, c.traffic, dev, table)
        else:
            system = rollout.ProgramRollout(c.config, c.traffic, dev, table)
            if what != "program":
                faults.rollout_fault(system, what)
        return rollout.run(c, seed=seed, seconds=seconds, trace=False, t_start=t,
                           system=system)
    system = train.ProgramTraining(c.config, c.traffic, dev, table, seed)
    if what == "control":
        faults.tf32_training(system)
    elif what != "program":
        faults.train_fault(system, what)
    return train.run(c, seed=seed, seconds=seconds, trace=False, t_start=t, system=system)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--what", default="control", help="comma-separated: program, control, "
                   "control_env (a train cell's env step, bfloat16), or a fault of "
                   "portbench/faults.py")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    c = harness.cell(args.workload)
    for what in args.what.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            try:
                out = reading(c, what, seed, args.seconds)
                compared = {n: v for n, v, _ in out.comparisons}
                compared["rate"] = next(v for k, v in out.end_to_end.items() if k != "setup_s")
            except Exception as e:  # a control that crashes has failed; go on
                traceback.print_exc()
                compared = {"error": f"{type(e).__name__}: {e}"}
            print(json.dumps({"workload": c.name, "seed": seed, "what": what,
                              "compared": compared}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
