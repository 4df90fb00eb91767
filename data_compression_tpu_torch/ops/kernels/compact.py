"""Block payload compaction (kernel: ``csrc/compact.cu``).

Replaces ``data_compression_tpu/ops/pallas/compact_kernel.py``
``compact_block_rows``: ``rows[b, :block_bytes[b]]`` land back to back,
in block order, in one flat uint8 tensor of exactly
``block_bytes.sum()`` bytes.  Offsets are tight; the TPU's 4 KiB
alignment was a Mosaic DMA rule and is gone.  ``rows`` may have any
width and start at any address, as may the output.

Host reads: ``compact_blocks(rows, block_bytes)`` reads back one small
device tensor (the total and the extremes of ``block_bytes``) to size
its output and check the bounds.  Given ``total``, the exact
``block_bytes.sum()`` that the caller already holds (the compress path
has it from the chunk digit counts), it reads nothing back and does not
synchronise: the bounds are then the caller's word, and the kernel
clamps each count to [0, row width] and writes nothing outside the
output, whatever the counts.
"""

from __future__ import annotations

import operator

import torch

from data_compression_tpu_torch.ops.kernels import _build


def _check(rows, block_bytes):
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be [B, N] uint8, got {rows.dtype} {tuple(rows.shape)}")
    B = rows.shape[0]
    if block_bytes.dtype != torch.int32 or tuple(block_bytes.shape) != (B,):
        raise ValueError(f"block_bytes must be [{B}] int32")
    return B


def _check_total(total):
    """``total`` as an int, or None; ValueError unless a count >= 0."""
    if total is None:
        return None
    try:
        count = operator.index(total)
    except TypeError:
        raise ValueError(f"total must be a byte count, got {total!r}") from None
    if count < 0:
        raise ValueError(f"total must be >= 0, got {count}")
    return count


def compact_blocks_ref(rows, block_bytes):
    """Plain PyTorch version (any device): slicing and torch.cat."""
    _check(rows, block_bytes)
    parts = [rows[b, :n] for b, n in enumerate(block_bytes.tolist())]
    if not parts:
        return torch.empty((0,), dtype=torch.uint8, device=rows.device)
    return torch.cat(parts)


def _check_out(out, total, device):
    if out.dtype != torch.uint8 or out.dim() != 1 or out.numel() != total:
        raise ValueError(f"out must be a [{total}] uint8 tensor")
    if out.device != device or not out.is_contiguous():
        raise ValueError("out must be contiguous, on the rows' device")


def compact_launcher(rows, block_bytes, total=None):
    """Check the inputs and compute the block offsets once; -> ``launch(out=None)``,
    which compacts into ``out`` (a [total] uint8 tensor, any alignment)
    or a new tensor: the CUDA kernel for CUDA tensors (no host read per
    call, for timing loops), the plain version for CPU tensors.  Without
    ``total`` the setup makes one host read; with it, none (see the
    module docstring)."""
    B = _check(rows, block_bytes)
    total = _check_total(total)
    if rows.device.type == "cpu":
        def launch_ref(out=None):
            flat = compact_blocks_ref(rows, block_bytes)
            if total is not None and flat.numel() != total:
                raise ValueError(f"total {total} != block_bytes.sum() {flat.numel()}")
            if out is None:
                return flat
            _check_out(out, flat.numel(), rows.device)
            return out.copy_(flat)
        return launch_ref
    _build.require_cuda(rows, block_bytes)
    N = rows.shape[1]
    ends = torch.cumsum(block_bytes, 0, dtype=torch.int64) if B else None
    if total is None:
        total = 0
        if B:
            least, most = torch.aminmax(block_bytes)
            total, least, most = torch.stack((ends[-1], least.long(), most.long())).tolist()
            if least < 0 or most > N:
                raise ValueError("block_bytes outside [0, row width]")
    elif total and not B:
        raise ValueError(f"total {total} from no blocks")

    def launch(out=None):
        if out is None:
            out = torch.empty((total,), dtype=torch.uint8, device=rows.device)
        else:
            _check_out(out, total, rows.device)
        if total:
            with torch.cuda.device(rows.device):
                rc = _build.lib().dct_compact(
                    rows.data_ptr(), ends.data_ptr(), out.data_ptr(), B, N, total,
                    _build.stream_of(rows),
                )
            _build.check(rc, "compact")
            _counted.launches += 1
        return out

    return launch


def compact_blocks(rows, block_bytes, total=None):
    """Compact on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  ``total``, where the caller holds
    it, is ``block_bytes.sum()``; it spares the host read (on the CPU a
    wrong one raises ValueError)."""
    return compact_launcher(rows, block_bytes, total)()


compact_blocks.launches = 0
_counted = compact_blocks  # the count stays on the wrapper while a caller swaps it
