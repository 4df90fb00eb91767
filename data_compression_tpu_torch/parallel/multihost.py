"""Multi-process pipeline: one process per device, one default group.

Counterpart of ``data_compression_tpu/parallel/multihost.py``.  Every
process calls with the same bytes (or file) and gets the identical frame;
rank 0 alone writes files.  The work is ``pipeline.compress_sharded`` /
``decompress_sharded`` over the default group, so per-block and shared
tables, padding and frame assembly are the pipeline's.

Run N processes (``torch.multiprocessing`` or one command per process),
each with its own rank:

    multihost.initialize("gloo", "tcp://127.0.0.1:29500", world_size=N, rank=r)
    frame = multihost.compress_multihost_bytes(data, CodecConfig(), device="cpu")

On GPUs use ``"nccl"`` and give each rank its device
(``initialize(..., device=torch.device("cuda", r))``).  A ``file://``
init method in a shared directory needs no port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from data_compression_tpu_torch.config import CodecConfig
from data_compression_tpu_torch.parallel.mesh import make_mesh
from data_compression_tpu_torch.parallel.pipeline import compress_sharded, decompress_sharded


def initialize(backend: str, init_method: str, world_size: int, rank: int,
               device=None) -> None:
    """Create the default process group.  An NCCL rank binds its CUDA
    ``device`` first, so it must be given."""
    if backend == "nccl":
        if device is None:
            raise ValueError("an NCCL rank needs its CUDA device")
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def process_local_block_ids(num_blocks: int) -> np.ndarray:
    """Strided ownership, as in the JAX package: rank p owns blocks p,
    p+P, p+2P, ...  (The pipeline itself shards contiguous ranges.)"""
    return np.arange(dist.get_rank(), num_blocks, dist.get_world_size())


def compress_multihost_bytes(data: bytes, config: CodecConfig, device="cuda") -> bytes:
    """Compress cooperatively across every process of the default group."""
    return compress_sharded(data, config, make_mesh(device))


def decompress_multihost_bytes(data: bytes, config: Optional[CodecConfig] = None,
                               device="cuda") -> bytes:
    """Decompress cooperatively; every process returns the whole stream."""
    return decompress_sharded(data, config, make_mesh(device))


def compress_multihost(local_data_path: str, out_path: str, config: CodecConfig,
                       device="cuda") -> dict:
    """File driver: every process calls with the same arguments; rank 0
    writes."""
    with open(local_data_path, "rb") as f:
        data = f.read()
    out = compress_multihost_bytes(data, config, device)
    if dist.get_rank() != 0:
        return {}
    with open(out_path, "wb") as f:
        f.write(out)
    return {"raw_bytes": len(data), "compressed_bytes": len(out),
            "hosts": dist.get_world_size()}


def decompress_multihost(in_path: str, out_path: str,
                         config: Optional[CodecConfig] = None, device="cuda") -> dict:
    """File driver for decompression; rank 0 writes."""
    with open(in_path, "rb") as f:
        data = f.read()
    out = decompress_multihost_bytes(data, config, device)
    if dist.get_rank() == 0:
        with open(out_path, "wb") as f:
            f.write(out)
    return {"compressed_bytes": len(data), "raw_bytes": len(out)}
