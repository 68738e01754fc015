"""Device meshes for sharded serving: one process per device.

Counterpart of ``src/repro/launch/mesh.py`` (``make_production_mesh``,
``make_local_mesh``, ``parse_mesh`` and the per-chip roofline constants).  The reference is one JAX controller over every device; the
port runs SPMD, one process per device, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data", "model")``
over the process group.  :class:`AbstractMesh` (axis names and sizes, no
devices) stands in for ``jax.sharding.AbstractMesh`` where only the spec rules
of ``distributed/sharding.py`` need a mesh.

:func:`make_production_mesh` is the reference's production mesh moved from a
TPU v5e pod to H100 cards: 32 HGX nodes of 8 cards, the ``model`` axis inside
a node's NVLink domain, ``data`` (and ``pod``) across nodes over InfiniBand.
It returns an :class:`AbstractMesh`: the dry-run (``launch/dryrun.py``)
counts one rank's program and never touches a device.  The per-card
constants below are the roofline's denominators (``launch/roofline.py``) and
every kernel's ``bound_ms``.

A mesh larger than 1x1 needs one process per device, started by ``torchrun``::

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 2x1 --device cpu
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

AXES = ("data", "model")

# NVIDIA H100 SXM 80 GB, per card: the card the port is measured on
PEAK_FLOPS_BF16 = 989e12    # FLOP/s, dense bf16 on the tensor cores (H100 SXM data sheet)
PEAK_FLOPS_FP32 = 67e12     # FLOP/s, fp32 outside the tensor cores (same sheet)
HBM_BW = 3.35e12            # bytes/s of HBM3 (same sheet)
# bytes/s per direction per card over NVLink 4: 18 links of 25 GB/s (the
# sheet's 900 GB/s counts both directions); the ``model`` axis
NVLINK_BW = 450e9
# bytes/s per card across nodes: one 400 Gb/s InfiniBand NDR port (ConnectX-7)
# per card in an HGX H100 node; the ``data`` and ``pod`` axes
IB_BW = 50e9
PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float32: PEAK_FLOPS_FP32}
LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}


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

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """``(32, 8)`` over ``("data", "model")``, 256 cards, or ``(2, 32, 8)``
    over ``("pod", "data", "model")``, 512: the reference's ``(16, 16)`` /
    ``(2, 16, 16)`` TPU v5e pods as HGX H100 nodes of 8 cards.  A model axis
    of 16 would cross nodes."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 32, 8))
    return AbstractMesh(("data", "model"), (32, 8))


def mesh_label(mesh) -> str:
    """``"32x8"``, ``"2x32x8"``: the axis sizes in order."""
    return "x".join(str(s) for s in mesh.shape.values())


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
