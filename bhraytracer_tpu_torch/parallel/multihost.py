"""Multi-process start-up (the port of bhraytracer_tpu/parallel/multihost.py).

One process per device, as torch.distributed runs data parallelism:

    torchrun --nproc_per_node=N my_render.py

    # my_render.py
    from bhraytracer_tpu_torch.parallel import (init_multihost, make_mesh,
                                                render_image_distributed)
    init_multihost()                # the group of the launcher's ranks
    mesh = make_mesh()              # 1-D, "dp", over every rank
    img = render_image_distributed(pack, camera, cfg, mesh)

Each rank renders its lane shard on its own card (cuda:LOCAL_RANK) with
the scene replicated; `render_image_distributed` all-gathers the shards,
and `train_step_sharded` all-reduces the parameter gradients, over NCCL.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# What torchrun exports to each rank; any of them makes a run multi-process.
LAUNCHER_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def rank_device(device=None) -> torch.device:
    """The rank's device: `device` where given, else the card of the
    launcher's LOCAL_RANK (0 without one). Raises where no CUDA device
    exists and the CPU was not asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def backend_for(device: torch.device, backend: Optional[str] = None) -> str:
    """NCCL for a card, gloo for the CPU, unless `backend` names one; gloo
    on a card is how several ranks share one card (NCCL refuses two ranks
    on one GPU). NCCL on the CPU raises."""
    backend = backend or ("gloo" if device.type == "cpu" else "nccl")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {device}")
    return backend


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device=None,
                   backend: Optional[str] = None) -> bool:
    """Join the process group of a multi-process run
    (torch.distributed.init_process_group); returns True.

    Returns False and does nothing in a single-process run: no
    coordinator given and none of LAUNCHER_VARS set. With
    `coordinator_address` ("host:port") the group meets at
    tcp://<coordinator_address> with world size `num_processes` and rank
    `process_id` (WORLD_SIZE and RANK where those are None); without one,
    at the launcher's env:// rendezvous.

    The backend comes from the device (`backend_for`): NCCL on the rank's
    card (`rank_device`: cuda:LOCAL_RANK unless `device` names one, made
    the current device), gloo for device="cpu"; backend="gloo" runs
    several ranks on one card. A failed init raises; no other backend or
    device is tried."""
    if coordinator_address is None and not any(
            os.environ.get(v) for v in LAUNCHER_VARS):
        return False
    dev = rank_device(device)
    kw = {}
    if coordinator_address is not None:
        world = num_processes if num_processes is not None else int(
            os.environ["WORLD_SIZE"])
        rank = process_id if process_id is not None else int(
            os.environ["RANK"])
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=world, rank=rank)
    else:
        kw["init_method"] = "env://"
        if num_processes is not None:
            kw["world_size"] = num_processes
        if process_id is not None:
            kw["rank"] = process_id
    init_group(dev, backend, **kw)
    return True


def init_group(device: torch.device, backend: Optional[str] = None,
               **kw) -> None:
    """init_process_group(**kw) on `backend_for(device, backend)`, the
    device made the current one; NCCL's communicator is made at once
    (device_id), so that a failed NCCL init raises here."""
    backend = backend_for(device, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(backend=backend, **kw)


def shutdown() -> None:
    """Leave the process group (jax.distributed.shutdown's counterpart);
    nothing without one."""
    if dist.is_initialized():
        dist.destroy_process_group()
