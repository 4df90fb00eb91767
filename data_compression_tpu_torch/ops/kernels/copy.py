"""uint8 pass-through copy (kernel: ``csrc/copy.cu``).

Replaces ``tools/ablate.py`` ``copy_call``, the TPU profiling tool's
pass-through kernel over [B, 512, 128] uint8 blocks: the dispatch and
memory floor that the codec kernels are read against.  The kernel copies
the tensor's bytes as one flat range, so it takes any contiguous uint8
tensor.
"""

from __future__ import annotations

import torch

from data_compression_tpu_torch.ops.kernels import _build


def _check(x):
    if x.dtype != torch.uint8:
        raise ValueError(f"x must be uint8, got {x.dtype}")


def copy_blocks_ref(x):
    """Plain PyTorch version (any device): ``x.clone()``."""
    _check(x)
    return x.clone()


def copy_blocks(x):
    """Copy on the tensor's device: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor.  -> a new tensor equal to ``x``."""
    if x.device.type == "cpu":
        return copy_blocks_ref(x)
    _check(x)
    _build.require_cuda(x)
    out = torch.empty_like(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("copy_blocks needs 16-byte aligned tensors")
    if x.numel():
        with torch.cuda.device(x.device):
            rc = _build.lib().dct_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                       _build.stream_of(x))
        _build.check(rc, "copy")
        copy_blocks.launches += 1
    return out


copy_blocks.launches = 0
