"""Process-group runtime: one process per rank on torch.distributed.

Port of sbsim_tpu/distributed/runtime.py. JAX runs one program over every
device of a slice once `jax.distributed.initialize` has run; PyTorch runs
one process per rank, each driving one device, joined by a process group.
`initialize` brings that group up from torchrun's variables (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or from explicit
arguments, and without either leaves a single process alone. The envs stay
rank-local; the replicated learner is kept consistent by identical updates
from mean-reduced gradients, so there is no parameter server.

The collectives the trainer needs are here too: the mean all-reduce of
gradients and statistics and the all-gather of row blocks. gloo reduces
host tensors, so for the gloo backend a CUDA tensor goes through the host
(`_through_host`, the one place that decides it); NCCL reduces on the card.
On NCCL each is one collective into one output tensor, with no host copy
and no host read, so a CUDA graph captures it (`captures`: the mesh's
steps are captured programs there, distributed/mesh.py); a gloo group's
host round trip cannot be captured.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from sbsim_tpu_torch import graphs


def initialize(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: Optional[float] = None,
) -> bool:
    """Joins this process to the process group of its job; returns whether
    this call created the group.

    World size and rank come from the arguments, else from WORLD_SIZE and
    RANK; the rendezvous from `init_method` (for example "file:///path" or
    "tcp://host:port"), else from MASTER_ADDR and MASTER_PORT ("env://").
    With none of these the process runs alone: no group is created. A
    process already in a group is left as it is.

    The backend is "nccl", one card per rank: this rank's card is
    LOCAL_RANK (else its rank), made the current device before any CUDA
    use. "gloo" runs the collectives on the host, for ranks on the CPU (or
    several ranks sharing one card, which NCCL refuses); it is used only
    when asked for. `timeout` (seconds) bounds the rendezvous and every
    collective.
    """
    if dist.is_initialized():
        return False
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and init_method is None:
        return False
    if world_size is None or rank is None:
        raise ValueError("a process group needs both its world size and this process's rank "
                         "(arguments, or WORLD_SIZE and RANK)")
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no rendezvous: pass init_method, or set MASTER_ADDR and "
                             "MASTER_PORT")
        init_method = "env://"
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the ranks run on CUDA devices (NCCL) and none is available; "
                               "pass backend='gloo' to run them on the CPU")
        backend = "nccl"
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if backend == "nccl":
        card = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(card)
        kwargs["device_id"] = card  # the group's collectives (barrier too) on this card
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kwargs)
    return True


def shutdown() -> None:
    """Leaves the process group (a no-op without one), after dropping every
    captured program (`graphs.release`): a graph holding the group's NCCL
    collectives must not outlive the group."""
    if dist.is_initialized():
        graphs.release()
        dist.destroy_process_group()


def process_info() -> dict:
    """The keys of the JAX package's process_info; a rank drives one
    device, so a process has one local device and the job one per rank."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1}
    n = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": n, "local_devices": 1,
            "global_devices": n}


def _through_host(group, x: torch.Tensor) -> bool:
    """gloo reduces host tensors: a tensor on a card goes through the host."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def captures(group) -> bool:
    """Whether a step whose collectives run on `group` can be captured into
    a CUDA graph: no group (no collective), or an NCCL group (collectives
    on the card). A gloo group's collectives go through the host
    (`_through_host`), which a graph cannot capture."""
    return group is None or dist.get_backend(group) == "nccl"


def all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean over the group's ranks of each float32 tensor, in one
    all-reduce of their concatenation (sum, then divided by the size)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if _through_host(group, flat):
        buf = flat.cpu()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        flat = buf.to(flat.device)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    mean = flat / dist.get_world_size(group)
    parts = mean.split([t.numel() for t in tensors])
    return [p.view(t.shape) for p, t in zip(parts, tensors)]


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block of rows (the same shape on each), concatenated in
    rank order along dim 0, on x's device: one all-gather into one tensor
    (bool travels as uint8)."""
    src = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    if _through_host(group, src):
        src = src.cpu()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    out = out.to(x.device)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def spawn(fn: Callable[..., Any], world_size: int, args: Sequence[Any] = (),
          timeout: float = 600.0) -> None:
    """Runs fn(rank, world_size, *args) in `world_size` new processes (the
    "spawn" start method: CUDA cannot be forked) and waits for all of them
    for at most `timeout` seconds. Each process joins the group itself
    (`initialize`). Raises RuntimeError when a process exits non-zero or
    the deadline passes; every process still running is killed first.
    `fn` must be importable by name from the new processes."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(rank, world_size, *args), daemon=True)
             for rank in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0]} exited with code {codes[bad[0]]}")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                raise RuntimeError(f"the ranks missed their {timeout:g} s deadline")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
