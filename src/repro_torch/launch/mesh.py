"""The mesh the multi-GPU paths run over: a
``torch.distributed.device_mesh.DeviceMesh`` with dimension names
``("data",)`` or ``("pod", "data")`` (the mesh constructor of
``repro.launch.mesh``; its TPU constants stay there).

On a ``("pod", "data")`` mesh rank ``p·data + d`` sits at coordinate
``(p, d)``, which is the reference's combined block index
``e = p·data + d``: rank e holds subgraphs and owner shards
``[e·k, (e+1)·k)``.

Run under ``torchrun`` (``env://``):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train_gnn \
      --pull collective --data-axis 2 --pods 2 --dist-backend gloo ...
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")


def make_mesh(data: int, pod: int = 1, device_type: str = "cpu"
              ) -> DeviceMesh:
    """The ``(pod, data)`` mesh over the initialised process group, whose
    world size must be ``pod · data``; ``("data",)`` alone when
    ``pod == 1``.  ``device_type`` names where the group's buffers live:
    ``"cuda"`` for NCCL, ``"cpu"`` for gloo (it stages through host
    memory, ``core.collectives``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    if data < 1 or pod < 1 or dist.get_world_size() != data * pod:
        raise ValueError(f"mesh pod={pod} x data={data} does not match "
                         f"the world size {dist.get_world_size()}")
    if pod > 1:
        return init_device_mesh(device_type, (pod, data),
                                mesh_dim_names=("pod", "data"))
    return init_device_mesh(device_type, (data,), mesh_dim_names=("data",))


def init_distributed(backend: str, device="cuda", data: int = None,
                     pod: int = 1) -> tuple[DeviceMesh, torch.device]:
    """Join the job ``torchrun`` started (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) over
    ``backend`` and build its mesh (``data`` defaults to the world size
    over ``pod``).  Returns ``(mesh, device)``: a CUDA rank runs on
    ``cuda:{LOCAL_RANK mod cards}``, so ranks beyond the card count
    share cards (gloo only: NCCL refuses two ranks on one card); the
    CPU only when ``device`` names it."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a CUDA device")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://",
            device_id=dev if backend == "nccl" else None)
    world = dist.get_world_size()
    if data is None:
        data = world // pod
    kind = "cuda" if backend == "nccl" else "cpu"
    return make_mesh(data, pod, kind), dev
