"""Device meshes for sharded serving: one process per device.

Counterpart of ``src/repro/launch/mesh.py`` (``make_local_mesh``,
``parse_mesh``).  The reference is one JAX controller over every device; the
port runs SPMD, one process per device, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data", "model")``
over the process group.  :class:`AbstractMesh` (axis names and sizes, no
devices) stands in for ``jax.sharding.AbstractMesh`` where only the spec rules
of ``distributed/sharding.py`` need a mesh.

``make_production_mesh`` and the per-device hardware constants of the
reference (its roofline denominators) come with the launch-tooling slice
(``launch/{specs,dryrun,roofline}.py``), with H100 figures in place of the
TPU's.

A mesh larger than 1x1 needs one process per device, started by ``torchrun``::

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 2x1 --device cpu
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device

AXES = ("data", "model")


class AbstractMesh:
    """Axis names and sizes without devices: what the spec functions read
    (``axis_names`` and a ``shape`` dict, as ``jax.sharding.AbstractMesh``
    gives them)."""

    def __init__(self, axis_names, sizes):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in sizes)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_names)} axis names but "
                             f"{len(sizes)} sizes")
        self.shape = dict(zip(self.axis_names, sizes))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def local_device(device=None) -> torch.device:
    """The device of this process: under ``torchrun`` the CUDA device of its
    ``LOCAL_RANK``, else :func:`~repro_torch.device.resolve_device`'s."""
    dev = resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A ``("data", "model")`` DeviceMesh of ``data * model`` processes.

    With no process group yet: a 1x1 mesh creates a world-1 group of its own
    from a ``HashStore`` (no port, no environment); under ``torchrun`` the
    group is made from its environment.  An existing group must hold exactly
    ``data * model`` processes.  Backend ``nccl`` on CUDA, ``gloo`` on the
    CPU.  ``device=None`` means CUDA and raises without it."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = local_device(device)
    n = data * model
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(_backend(dev))
        elif n == 1:
            dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise ValueError(
                f"mesh {data}x{model} needs {n} processes and no process "
                f"group is initialised (launch under torchrun "
                f"--nproc-per-node {n})")
    have = dist.get_world_size()
    if have != n:
        raise ValueError(f"mesh {data}x{model} needs {n} processes, the "
                         f"process group holds {have}")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES)


def parse_mesh(spec: str, device=None):
    """Build a ("data", "model") mesh from a ``DxM`` flag string (e.g.
    ``2x1``, ``1x2``): the serving launcher's ``--mesh``.  The product must
    equal the number of processes (start them with ``torchrun
    --nproc-per-node D*M``)."""
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"--mesh expects DxM (e.g. 8x1), got {spec!r}")
    data, model = (int(p) for p in parts)
    have = (dist.get_world_size() if dist.is_initialized()
            else int(os.environ.get("WORLD_SIZE", 1)))
    if data * model > have:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, "
            f"{have} visible (launch under torchrun "
            f"--nproc-per-node {data * model})")
    return make_local_mesh(data, model, device=device)
