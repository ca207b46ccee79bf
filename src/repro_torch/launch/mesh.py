"""The mesh of a run: its axes from ``--mesh`` and its process groups
(counterpart of ``repro.launch.mesh``'s ``make_smoke_mesh``/``bind_4d``).

A mesh of one rank needs no process group. A mesh of more ranks runs one
process per rank, started by ``torch.distributed.run``, which sets
``RANK``, ``WORLD_SIZE`` and the rendezvous address; the world size must
equal the mesh's product. Rank r sits at the row-major coordinates of r
over (data, x, y, z, seq, expert) and every rank creates the group of each axis
and axis tuple (``core.mesh.init_groups``). The backend is gloo, on the
CPU and on the card (CUDA tensors are staged through host memory by
``core.mesh``); NCCL with one rank per card is the ROADMAP.md §1 item
"multi-rank mesh". Rank r runs on card ``r % torch.cuda.device_count()``,
so ranks beyond the card count share cards. The groups have a finite
timeout, so a collective that one rank never issues fails instead of
hanging.
"""
from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist

from repro_torch.core import mesh as M

BACKENDS = ("gloo",)
TIMEOUT_S = 60


def mesh_axes(spec: str) -> M.MeshAxes:
    """``"g_data,g_x,g_y,g_z[,g_seq[,g_expert]]"`` -> MeshAxes."""
    return M.MeshAxes(tuple(int(x) for x in spec.split(",")))


def init_mesh(axes: M.MeshAxes, *, backend: str = "gloo",
              device="cuda") -> dict:
    """Join the process group of ``axes`` (none for one rank), create the
    groups of its axes and pick this rank's device. Returns {"device",
    "rank", "world", "ranks_per_card" (None off the card)}."""
    if backend == "nccl":
        raise NotImplementedError(
            "--backend nccl (one rank per card) is not ported to PyTorch "
            "yet: it waits for the ROADMAP.md §1 item 'multi-rank mesh'")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port runs {BACKENDS}")
    world = math.prod(axes.sizes)
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if env_world != world:
        raise ValueError(
            f"mesh {axes.sizes} has {world} ranks but WORLD_SIZE is "
            f"{env_world}: run it under python -m torch.distributed.run "
            f"--standalone --nproc-per-node {world}")
    rank = int(os.environ.get("RANK", "0"))
    dev = torch.device(device)
    per_card = None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but torch sees no CUDA "
                f"device; pass device='cpu' (--device cpu) to run on the "
                f"CPU")
        n = torch.cuda.device_count()
        per_card = -(-world // n)
        if per_card > 1:
            # ranks sharing a card share its memory: segments that grow
            # in place fragment it less than fixed-size ones
            os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                                  "expandable_segments:True")
        dev = torch.device("cuda", rank % n)
        torch.cuda.set_device(dev)
    if world > 1:
        dist.init_process_group(
            backend, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        M.init_groups(axes)
    return {"device": dev, "rank": rank, "world": world,
            "ranks_per_card": per_card}


def close_mesh() -> None:
    M.clear_groups()
    if dist.is_initialized():
        dist.destroy_process_group()
