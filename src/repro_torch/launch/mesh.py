"""The mesh the multi-GPU paths run over: a
``torch.distributed.device_mesh.DeviceMesh`` with dimension names
``("data",)`` or ``("pod", "data")``, and ``"model"`` last where the
experts are sharded (the mesh constructor of ``repro.launch.mesh``), the
production mesh (:func:`make_production_mesh`), the H100 constants of
the dry run's roofline terms in place of the reference's TPU ones, and
:func:`dry_group`, the stand-in process group the dry run
(``launch.dryrun``) runs one rank of.

On a ``("pod", "data")`` mesh rank ``p·data + d`` sits at coordinate
``(p, d)``, which is the reference's combined block index
``e = p·data + d``: rank e holds subgraphs and owner shards
``[e·k, (e+1)·k)``.  A ``"model"`` dimension (the expert-parallel MoE,
``models.moe.moe_ep``) puts rank ``(p·data + d)·model + m`` at
``(p, d, m)``, as ``jax.make_mesh`` lays out the reference's
``make_host_mesh``; the GNN paths, whose rank is a block index, refuse
it (:func:`refuse_model_dim`), and the LM model and trainer shard their
parameters over it (``distributed.sharding``).

Run under ``torchrun`` (``env://``):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train_gnn \
      --pull collective --data-axis 2 --pods 2 --dist-backend gloo ...
"""
from __future__ import annotations

import contextlib
import gc
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")

# Hardware constants of the dry run's roofline terms: NVIDIA H100 SXM5
# 80GB HBM3 at 700 W, published peaks (NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 column, dense, no sparsity): the tensor cores' bf16 and
# TF32 rates, fp32 outside the tensor cores, HBM3 bandwidth, NVLink 4
# (900 GB/s a card both ways, 450e9 each way).  The network: one 400 Gb/s
# NDR InfiniBand port a card (NVIDIA DGX H100 user guide: eight ConnectX-7
# ports for eight cards), 50e9 B/s each way.  Predictions from data-sheet
# peaks, not measurements.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BW = 3.35e12             # bytes/s a card
NVLINK_BW = 450e9            # bytes/s a card, each way
NET_BW = 50e9                # bytes/s a card, each way
POD_SHAPE = (16, 16)         # ("data", "model") of one production pod


def make_mesh(data: int, pod: int = 1, device_type: str = "cpu",
              model: int = 1) -> DeviceMesh:
    """The ``(pod, data, model)`` mesh over the initialised process group,
    whose world size must be ``pod · data · model``; "pod" only when
    ``pod > 1`` and "model" only when ``model > 1`` (``("data",)`` alone
    otherwise).  ``device_type`` names where the group's buffers live:
    ``"cuda"`` for NCCL, ``"cpu"`` for gloo (it stages through host
    memory, ``core.collectives``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if min(data, pod, model) < 1 or world != data * pod * model:
        raise ValueError(f"mesh pod={pod} x data={data} x model={model} "
                         f"does not match the world size {world}")
    dims = ([("pod", pod)] if pod > 1 else []) + [("data", data)] + (
        [("model", model)] if model > 1 else [])
    from repro_torch.core import collectives
    collectives.set_pod_ranks(data * model if pod > 1 else 0)
    return init_device_mesh(device_type, tuple(n for _, n in dims),
                            mesh_dim_names=tuple(a for a, _ in dims))


def make_production_mesh(*, multi_pod: bool = False, pods: int = None,
                         device_type: str = "cpu") -> DeviceMesh:
    """The reference's production mesh over the initialised group: one
    pod is (16, 16) over ("data", "model"), 256 ranks; several are
    (pods, 16, 16) over ("pod", "data", "model") (``pods`` defaults to 2
    under ``multi_pod``).  The world size must be ``256 · pods``
    (ValueError naming it otherwise); the reference's ValueError where
    ``pods`` contradicts ``multi_pod``."""
    if pods is None:
        pods = 2 if multi_pod else 1
    if pods < 1 or (multi_pod and pods < 2):
        raise ValueError(f"pods={pods} contradicts multi_pod={multi_pod}"
                         f" — multi-pod needs pods >= 2, single-pod "
                         f"exactly pods=1 (or omit pods)")
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised "
                           "process group (dry_group for a dry run)")
    data, model = POD_SHAPE
    world = dist.get_world_size()
    if world != pods * data * model:
        raise ValueError(f"the production mesh of {pods} pod(s) needs a "
                         f"world size of {pods * data * model}, not "
                         f"{world}")
    return make_mesh(data, pods, device_type, model)


@contextlib.contextmanager
def dry_group(world: int, rank: int = 0):
    """Be rank ``rank`` of a stand-in process group of ``world`` ranks
    (PyTorch's fake backend on the CPU and meta devices): every
    collective returns at once without moving data, so one process runs
    one rank's program over meta tensors.  Refuses (RuntimeError) under
    an initialised group, so it never stands in for a real job; destroys
    the group on exit (:func:`close_distributed`)."""
    if dist.is_initialized():
        raise RuntimeError("dry_group: a process group is initialised "
                           "already; a dry run never joins a real job")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=rank, world_size=world)
    try:
        yield
    finally:
        close_distributed()


def dim_size(mesh: DeviceMesh, name: str) -> int:
    """The size of ``mesh``'s dimension ``name``; 1 where it has none."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def refuse_model_dim(mesh: DeviceMesh, what: str) -> None:
    """ValueError for a ``"model"`` dimension above 1 on a path whose rank
    is a block index (``p·data + d``)."""
    if mesh is not None and dim_size(mesh, "model") > 1:
        raise ValueError(
            f"{what}: the mesh's 'model' dimension is "
            f"{dim_size(mesh, 'model')}; this path lays its blocks over "
            f"('pod', 'data') only (a 'model' dimension shards the MoE's "
            f"experts, models.moe.moe_ep)")


def init_distributed(backend: str, device="cuda", data: int = None,
                     pod: int = 1, model: int = 1, production: bool = False
                     ) -> tuple[DeviceMesh, torch.device]:
    """Join the job ``torchrun`` started (``env://``: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) over
    ``backend`` and build its mesh (``data`` defaults to the world size
    over ``pod · model``; ``production``: :func:`make_production_mesh` of
    ``pod`` pods, ``data`` and ``model`` unused).  Returns ``(mesh,
    device)``: a CUDA rank runs on
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
    kind = "cuda" if backend == "nccl" else "cpu"
    try:
        if production:
            return make_production_mesh(pods=pod, device_type=kind), dev
        if data is None:
            data = dist.get_world_size() // (pod * model)
        return make_mesh(data, pod, kind, model), dev
    except ValueError:
        close_distributed()          # a mesh the job cannot form
        raise


def close_distributed() -> None:
    """Destroy the job's process groups, once the caller has dropped its
    last reference to the job's ``DeviceMesh``.  A mesh holds its groups,
    so ``destroy_process_group`` alone leaves a gloo group alive until
    the interpreter shuts down, and freeing it there can abort the rank
    ("terminate called without an active exception"), the more often the
    sooner its peers have exited; the collection here frees the groups
    first, in order."""
    gc.collect()
    dist.destroy_process_group()
    from repro_torch.core import collectives
    collectives.set_pod_ranks(0)
