"""Per-block byte histograms.

Replaces ``data_compression_tpu/ops/histogram.py:block_histograms``, an
XLA one-hot matmul shaped for the TPU's matrix unit (not a Pallas
kernel).  Here it is one ``index_add_`` of ones into a preallocated
[B*256 + 1] tensor at the flattened bin ``b * 256 + v``; positions past a
block's valid length go to the extra bin, which is dropped.  The output
size is known before the call, so nothing is read back and nothing
synchronises (``torch.bincount`` reads its input's maximum back to size
its output): the device pipeline (``device_api``) runs it between
device tensors.
"""

from __future__ import annotations

import torch


def block_histograms(blocks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, S] uint8 + [B] valid lengths -> [B, 256] int64 counts, on the
    blocks' device, without a host read."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError(f"blocks must be [B, S] uint8, got {blocks.dtype} {tuple(blocks.shape)}")
    B, S = blocks.shape
    dev = blocks.device
    idx = blocks.to(torch.int32)
    idx += torch.arange(B, device=dev, dtype=torch.int32)[:, None] * 256
    valid = torch.arange(S, device=dev)[None, :] < lengths.to(dev, torch.int64)[:, None]
    idx.masked_fill_(~valid, B * 256)
    counts = torch.zeros(B * 256 + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, idx.view(-1), torch.ones((), dtype=torch.int64, device=dev).expand(B * S))
    return counts[: B * 256].view(B, 256)
