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

``measure_encode_throughput`` is the scaling harness's step (the
counterpart of the JAX package's): the rows encode kernel on each rank's
share of a synthetic corpus, with and without the all-gather of its
per-chunk byte counts.  ``tools.scaling_bench`` runs it under 1 and N
processes.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from data_compression_tpu_torch import framing
from data_compression_tpu_torch.api import BytesLike, _as_bytes
from data_compression_tpu_torch.config import CodecConfig, wire_bytes
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.models.huffman import capped_lengths
from data_compression_tpu_torch.ops.kernels import encode as kencode
from data_compression_tpu_torch.parallel.mesh import Mesh, make_mesh
from data_compression_tpu_torch.parallel.pipeline import (
    _all_gather, _pad_blocks, compress_sharded, decompress_sharded, require_fast_arity,
)
from data_compression_tpu_torch.utils.corpora import synthetic_enwik


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


def compress_multihost_bytes(data: BytesLike, config: CodecConfig, device="cuda") -> bytes:
    """Compress cooperatively across every process of the default group.

    Non-empty input gives ``compress_sharded``'s frame.  Empty input
    gives the JAX package's multihost frame, not its sharded one: JAX
    ``compress_multihost_bytes`` pads it to one zero-length block a
    device and runs its steps, so the header records the chunk size, a
    shared table is the one of an all-zero histogram, and an arity
    without a sharded encode raises KeyError; JAX ``compress_sharded``
    (and so the port's) returns early with none of these."""
    mesh = make_mesh(device)
    raw = _as_bytes(data)
    if raw or config.codec != "huffman":
        return compress_sharded(raw, config, mesh)
    require_fast_arity(config.arity)
    shared = None
    if config.shared_table:
        zeros = np.zeros(256, np.int64)
        shared = np.asarray(capped_lengths(zeros, config.arity), np.uint8).tobytes()
    return framing.pack_frame(config.codec_id, config.arity, config.block_size, 0,
                              [], [], [], [], shared_table=shared,
                              chunk_log2=config.chunk_syms.bit_length() - 1)


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


# ----------------------------------------------------------------------
# Scaling-efficiency harness
# ----------------------------------------------------------------------


def encode_share(config: CodecConfig, nbytes: int, mesh: Mesh):
    """``measure_encode_throughput``'s input on this rank: the blocks of
    ``synthetic_enwik(nbytes, seed=7)`` padded with zero-length blocks to
    a multiple of the world size, the rank's contiguous share of them and
    of their raw lengths, and the run's one table (canonical code of the
    byte counts of the whole padded [B, S] array), on the rank's device.
    -> (blocks [B/world, S] uint8, raw lengths int32, dense encode table)."""
    blocks, lengths = framing.split_blocks(synthetic_enwik(nbytes, seed=7), config.block_size)
    blocks, lengths = _pad_blocks(blocks, lengths, mesh.world_size)
    hist = np.bincount(blocks.reshape(-1), minlength=256).astype(np.int64)
    row = np.asarray(capped_lengths(hist, config.arity), np.int32)
    per = blocks.shape[0] // mesh.world_size
    lo = mesh.rank * per
    table = hb.codes_batch(np.tile(row, (per, 1)), config.arity)
    dense = hb.encode_tensors(table, mesh.device)["dense"]
    local = torch.from_numpy(blocks[lo : lo + per]).to(mesh.device)
    lens = torch.from_numpy(lengths[lo : lo + per].astype(np.int32)).to(mesh.device)
    return local, lens, dense


def encode_counts(blocks, lens, dense, config: CodecConfig,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The step that ``measure_encode_throughput`` times: the rows encode
    kernel on this rank's share, each chunk's wire bytes, and with a mesh
    their all-gather in rank order ([B * S/C] on every rank, the JAX
    step's replicated ``nb``); without one the rank's own counts (the
    compute step)."""
    _, digits = kencode.encode_chunk_rows(blocks, lens, dense, config.chunk_syms, config.arity)
    nb = wire_bytes(digits, config.arity)
    return nb if mesh is None else _all_gather(nb, mesh)


def measure_encode_throughput(config: CodecConfig, nbytes: int, iters: int = 4,
                              device="cuda") -> dict:
    """Steady-state sharded-encode throughput on the current topology:
    the best of ``iters`` wall times of the full step (encode, wire bytes,
    all-gather of the counts) and of the compute step (no gather) over
    ``encode_share``'s corpus, both warmed up first, the ranks held
    together by a barrier before each timed call.  Called under 1 and N
    processes, the ratio gives the scaling efficiency

        eff = (bytes_per_s_N / N) / bytes_per_s_1

    One device per rank, so ``devices`` is the world size."""
    mesh = make_mesh(device)
    share = encode_share(config, nbytes, mesh)
    barrier_ids = [mesh.device.index] if mesh.device.type == "cuda" else None

    def wall_s(step) -> float:
        dist.barrier(group=mesh.group, device_ids=barrier_ids)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        step()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return time.perf_counter() - t0

    def full():
        encode_counts(*share, config, mesh)

    def compute():
        encode_counts(*share, config)

    wall_s(full)  # warm up
    wall_s(compute)
    best = best_local = float("inf")
    for _ in range(iters):
        best = min(best, wall_s(full))
        best_local = min(best_local, wall_s(compute))
    return {
        "bytes": nbytes,
        "best_s": best,
        "bytes_per_s": nbytes / best,
        "compute_s": best_local,
        "collective_s": max(0.0, best - best_local),
        "processes": mesh.world_size,
        "devices": mesh.world_size,
    }
