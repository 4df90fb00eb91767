"""Process mesh over a ``torch.distributed`` group.

Counterpart of ``data_compression_tpu/parallel/mesh.py``.  Independent
fixed-size blocks are the sharding axis; the mesh keeps the reference's
``("data", "chunk")`` axis names and shape, but every rank owns whole
blocks: blocks are sharded over all ``data * chunk`` ranks in rank
order, so the frame never depends on the shape.  One rank is one
process with one device: a CUDA device under an NCCL group, the CPU
under a gloo group.

The group must already exist (``torch.distributed.init_process_group``,
or ``parallel.multihost.initialize``); nothing here creates one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "chunk")
_BACKEND_OF_DEVICE = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group with the device of this rank."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    rank: int
    world_size: int
    shape: Tuple[int, int]  # ("data", "chunk")
    device: torch.device

    axis_names = AXES


def make_mesh(device, shape: Optional[Tuple[int, int]] = None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """Mesh of the ranks of ``group`` (default: the default group) with
    this rank's ``device``.  Raises if no group is initialized, if the
    group's backend does not serve the device (CUDA needs NCCL, the CPU
    gloo), or if ``shape`` does not cover the world."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call "
            "torch.distributed.init_process_group (or parallel.multihost."
            "initialize) first"
        )
    device = torch.device(device)
    want = _BACKEND_OF_DEVICE.get(device.type)
    backend = dist.get_backend(group)
    if want is None or want not in str(backend):  # "cpu:gloo,cuda:nccl" serves both
        raise ValueError(
            f"device {device} needs a {want or 'cuda or cpu'} group, "
            f"got a {backend} group"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size(group)
    shape = (world, 1) if shape is None else tuple(shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    return Mesh(group, dist.get_rank(group), world, shape, device)
