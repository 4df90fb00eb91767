"""Block payload compaction (kernel: ``csrc/compact.cu``).

Replaces ``data_compression_tpu/ops/pallas/compact_kernel.py``
``compact_block_rows``: ``rows[b, :block_bytes[b]]`` land back to back,
in block order, in one flat uint8 tensor of exactly
``block_bytes.sum()`` bytes.  Offsets are tight; the TPU's 4 KiB
alignment was a Mosaic DMA rule and is gone.
"""

from __future__ import annotations

import torch

from data_compression_tpu_torch.ops.kernels import _build


def _check(rows, block_bytes):
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be [B, N] uint8, got {rows.dtype} {tuple(rows.shape)}")
    B = rows.shape[0]
    if block_bytes.dtype != torch.int32 or tuple(block_bytes.shape) != (B,):
        raise ValueError(f"block_bytes must be [{B}] int32")
    return B


def compact_blocks_ref(rows, block_bytes):
    """Plain PyTorch version (any device): slicing and torch.cat."""
    _check(rows, block_bytes)
    parts = [rows[b, :n] for b, n in enumerate(block_bytes.tolist())]
    if not parts:
        return torch.empty((0,), dtype=torch.uint8, device=rows.device)
    return torch.cat(parts)


def compact_blocks(rows, block_bytes):
    """Compact on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Reads the total size back to the
    host to allocate the output."""
    if rows.device.type == "cpu":
        return compact_blocks_ref(rows, block_bytes)
    B = _check(rows, block_bytes)
    _build.require_cuda(rows, block_bytes)
    if bool((block_bytes < 0).any()) or bool((block_bytes > rows.shape[1]).any()):
        raise ValueError("block_bytes outside [0, row width]")
    bb = block_bytes.to(torch.int64)
    ends = torch.cumsum(bb, 0)
    starts = ends - bb
    total = int(ends[-1]) if B else 0
    flat = torch.empty((total,), dtype=torch.uint8, device=rows.device)
    if B:
        with torch.cuda.device(rows.device):
            rc = _build.lib().dct_compact(
                rows.data_ptr(), starts.data_ptr(), block_bytes.data_ptr(),
                flat.data_ptr(), B, rows.shape[1], _build.stream_of(rows),
            )
        _build.check(rc, "compact")
        compact_blocks.launches += 1
    return flat


compact_blocks.launches = 0
