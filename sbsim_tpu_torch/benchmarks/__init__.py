"""The scripts beside the package, on the port: each runs as
`python -m sbsim_tpu_torch.benchmarks.<name>` with the JAX script's name,
flags and JSON fields, on the card unless `--cpu` is given, and adds one
`card` field to its JSON (`card_line`).
"""

from __future__ import annotations

import subprocess

import torch


def card_line(device) -> str:
    """The card a script ran on, as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives it for the device's index; "cpu" on the
    CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()
