"""Runs one cell of the port's benchmark once and prints one JSON line.

    python3 portbench/run.py --workload office12.rollout --seed 1234 --seconds 20 --trace 0

From the root of a checkout that holds BENCHMARK.json, portbench/ and the
program (sbsim_tpu_torch/), on a machine with the cards the cell asks for.
It builds the cell's configuration, warms up the shapes its traffic uses,
measures for --seconds, checks what the timed path produced against the
plain reference (portbench/oracle/), and prints the result as the last
line of standard output, with each compared number beside its limit as the
last lines of standard error. With --trace 1 the line carries the per-layer
metrics instead of the end-to-end ones.

Exits 2 without a result where no card, too few cards, or no program is
found, and 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fixed_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's nvcc libraries already build into sbsim_tpu_torch/_build/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    args = parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    fixed_caches()
    import torch

    from portbench import harness

    c = harness.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {c.name} needs {c.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "sbsim_tpu_torch")):
        print("portbench: the program (sbsim_tpu_torch/) is not in this checkout",
              file=sys.stderr)
        return 2
    drv = harness.driver(c.traffic["kind"])
    outcome = drv.run(c, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    line = harness.result_line(c, outcome, bool(args.trace), torch.cuda.get_device_name(0))
    harness.print_comparisons(outcome.comparisons)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
