"""Per-block byte histograms (kernel: ``csrc/histogram.cu``).

Replaces ``data_compression_tpu/ops/histogram.py:block_histograms``, an
XLA one-hot matmul shaped for the TPU's matrix unit (not a Pallas
kernel).  In:

  blocks [B, S] uint8 — any row stride; bytes of a row must be
      contiguous, or the tensor is copied to a contiguous one first;
  lengths [B] — valid bytes of each row (clamped to 0..S).

Out: [B, 256] int64 counts of the bytes before each row's length, on the
blocks' device.  The kernel reads nothing back and allocates only its
output, so the device pipeline (``device_api``) runs it between device
tensors; every compress path (``models/huffman.py``, the sharded
``parallel/pipeline.py``, ``device_api``) takes its histograms here.

The plain version ``block_histograms_ref`` is one ``index_add_`` of ones
into a preallocated [B*256 + 1] tensor at the flattened bin
``b * 256 + v``, positions past a row's length going to the extra bin,
which is dropped (``torch.bincount`` would read its input's maximum back
to size its output).
"""

from __future__ import annotations

import torch

from data_compression_tpu_torch.ops.kernels import _build

MIN_SLICE = 16384  # bytes: a CTA's round (64 threads x 256 bytes); no slice is cut shorter
MAX_SLICES = 8  # a row's slices are one thread-block cluster (the portable size)


def _check(blocks, lengths):
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError(f"blocks must be [B, S] uint8, got {blocks.dtype} {tuple(blocks.shape)}")
    if lengths.shape != blocks.shape[:1] or lengths.is_floating_point():
        raise ValueError(f"lengths must be [{blocks.shape[0]}] integers, got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")


def block_histograms_ref(blocks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device): ``index_add_`` of ones."""
    _check(blocks, lengths)
    B, S = blocks.shape
    dev = blocks.device
    idx = blocks.to(torch.int32)
    idx += torch.arange(B, device=dev, dtype=torch.int32)[:, None] * 256
    valid = torch.arange(S, device=dev)[None, :] < lengths.to(dev, torch.int64)[:, None]
    idx.masked_fill_(~valid, B * 256)
    counts = torch.zeros(B * 256 + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, idx.view(-1), torch.ones((), dtype=torch.int64, device=dev).expand(B * S))
    return counts[: B * 256].view(B, 256)


def slices_for(B: int, S: int, sms: int) -> int:
    """Slices (CTAs of one cluster) per row, 1, 2, 4 or 8: doubled while
    the B rows give fewer CTAs than ``sms`` SMs and each slice keeps at
    least MIN_SLICE bytes (the streamed batch of 256 rows ran faster
    uncut than in 2 or 4 slices a row, PERF.md)."""
    slices = 1
    while slices < MAX_SLICES and B * slices < sms and S >= 2 * slices * MIN_SLICE:
        slices *= 2
    return slices


def block_histograms(blocks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Histograms on the blocks' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  -> [B, 256] int64."""
    if blocks.device.type == "cpu":
        return block_histograms_ref(blocks, lengths)
    _check(blocks, lengths)
    if blocks.stride(1) != 1:
        blocks = blocks.contiguous()
    lengths = lengths.to(blocks.device, torch.int32).contiguous()
    _build.require_cuda(lengths)
    if blocks.device != lengths.device:
        raise ValueError(f"tensors on different devices: {lengths.device} vs {blocks.device}")
    B, S = blocks.shape
    out = torch.empty((B, 256), dtype=torch.int64, device=blocks.device)
    if B:
        sms = _build.sm_count(blocks.device)
        with torch.cuda.device(blocks.device):
            rc = _build.lib().dct_histogram(blocks.data_ptr(), blocks.stride(0),
                                            lengths.data_ptr(), out.data_ptr(), B, S,
                                            slices_for(B, S, sms),
                                            _build.stream_of(blocks))
        _build.check(rc, "histogram")
        block_histograms.launches += 1
    return out


block_histograms.launches = 0
