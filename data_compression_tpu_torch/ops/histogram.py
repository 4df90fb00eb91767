"""Per-block byte histograms.

Replaces ``data_compression_tpu/ops/histogram.py:block_histograms``, an
XLA one-hot matmul shaped for the TPU's matrix unit (not a Pallas
kernel).  Here it is one ``torch.bincount`` over the flattened bin
index ``b * 256 + v``; positions past a block's valid length go to one
extra bin that is dropped, so no boolean indexing (and no host sync)
is needed.
"""

from __future__ import annotations

import torch


def block_histograms(blocks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, S] uint8 + [B] valid lengths -> [B, 256] int64 counts."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError(f"blocks must be [B, S] uint8, got {blocks.dtype} {tuple(blocks.shape)}")
    B, S = blocks.shape
    pos = torch.arange(S, device=blocks.device)
    valid = pos[None, :] < lengths.to(blocks.device, torch.int64)[:, None]
    row = torch.arange(B, device=blocks.device, dtype=torch.int64)[:, None] * 256
    idx = torch.where(valid, row + blocks.to(torch.int64), B * 256)
    counts = torch.bincount(idx.reshape(-1), minlength=B * 256 + 1)
    return counts[: B * 256].reshape(B, 256)
