"""Mesh construction over the ranks of the process group.

The port of ``repro/launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with axes ``("data",
"model")``.  Its ranks are processes, started by ``python -m
torch.distributed.run`` (which sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``) or by a test that gives ``init_process_group`` its own
rendezvous.  With no process group and a 1×1 mesh, :func:`make_local_mesh`
starts a world of one itself: NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

__all__ = [
    "init_distributed", "line_out", "make_local_mesh", "make_production_mesh", "pick_backend",
]


#: ranks of the fake world the production meshes live in: enough for 2×16×16
FAKE_WORLD = 512


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 chips per pod (single pod) or 2×16×16 = 512 chips, as the
    reference's, over torch's ``fake`` process group: a world of
    :data:`FAKE_WORLD` ranks in this one process, in which this process is rank 0
    and every collective returns at once.  It is for the dry run
    (``repro_torch.launch.dryrun``), under ``FakeTensorMode``: nothing is
    allocated or sent.  A fake world cannot share a process with a real one: this
    raises if another process group is up.

    Axes: ``pod``, data-parallel across the cross-pod links; ``data``, the batch,
    FSDP and ZeRO axis; ``model``, the tensor and expert parallel axis, kept
    innermost."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=FAKE_WORLD)
    elif dist.get_backend() != "fake":
        raise RuntimeError("the production mesh lives in a fake world; this process has a "
                           f"{dist.get_backend()} process group")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=axes)


def line_out(msg: str) -> None:
    """Print one line in one write: the ranks of a ``torch.distributed.run``
    launch share their parent's stdout, and a line written in pieces can be
    cut by another rank's."""
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def pick_backend(device: torch.device, world_size: int) -> str:
    """NCCL when every rank has a card of its own (or the world is one rank);
    gloo when ranks share a card, or on the CPU.  NCCL refuses two ranks on one
    device.  The ranks that share a node's cards are that node's
    (``LOCAL_WORLD_SIZE``, which ``torch.distributed.run`` sets); without it the
    whole world is taken to be on one node."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if world_size == 1 or local <= torch.cuda.device_count() else "gloo"


def init_distributed(device: torch.device) -> str:
    """Join the process group of a ``torch.distributed.run`` launch (from its
    environment), or start a world of one on ``localhost``; returns the
    backend.  A CUDA rank takes ``cuda:{LOCAL_RANK % device_count}``."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
        torch.cuda.init()
    backend = pick_backend(device, world)
    if dist.is_initialized():
        return dist.get_backend()
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    else:
        if world != 1:
            raise RuntimeError(f"WORLD_SIZE {world} without MASTER_ADDR: start the ranks "
                               "with python -m torch.distributed.run")
        store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
        dist.init_process_group(backend, init_method=f"file://{store}", rank=0, world_size=1)
    return backend


def make_local_mesh(data: int = 1, model: int = 1, *, device: str | torch.device = "cuda"):
    """A ``(data, model)`` mesh over the ranks of the process group.

    Raises when ``data × model`` is not the world size (the reference raises on
    too few devices).  Without a process group it joins the one a
    ``torch.distributed.run`` launch describes in its environment, or starts a
    world of one for a 1×1 mesh (:func:`init_distributed`: NCCL on the card, the
    default ``device``, gloo on the CPU).  Over gloo on the card, the mesh's
    shards are gathered with c10d's collective
    (:func:`repro_torch.parallel.gather_through_c10d`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import gather_through_c10d

    device = torch.device(device)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if data * model != world:
            raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks, the world has "
                             f"{world}: start them with python -m torch.distributed.run")
        init_distributed(device)
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks, the world has "
                         f"{world}")
    mesh = init_device_mesh(device.type, (data, model), mesh_dim_names=("data", "model"))
    if device.type == "cuda" and dist.get_backend() == "gloo":
        gather_through_c10d(mesh)
    return mesh
