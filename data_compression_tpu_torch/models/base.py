"""Codec interface (counterpart of ``data_compression_tpu/models/base.py``).

A codec consumes and produces blocks, the independent unit of
parallelism.  Host boundary types are numpy and bytes; the tensors of a
codec live on the ``device`` it was made for.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from data_compression_tpu_torch.config import CodecConfig


@dataclasses.dataclass
class EncodeResult:
    """Per-block payloads plus an optional stream-level shared table."""

    payloads: List[bytes]
    shared_table: Optional[bytes] = None


class Codec(abc.ABC):
    """Block codec. Implementations must be deterministic: the same
    input blocks yield byte-identical payloads on every device."""

    name: str = "base"

    def __init__(self, config: CodecConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)

    @abc.abstractmethod
    def encode_blocks(self, blocks: np.ndarray, lengths: np.ndarray) -> EncodeResult:
        """Encode [num_blocks, block_size] uint8 rows (valid prefix per
        ``lengths``) into per-block payloads."""

    @abc.abstractmethod
    def decode_blocks(
        self,
        payloads: List[bytes],
        raw_lens: List[int],
        shared_table: Optional[bytes] = None,
    ) -> List[bytes]:
        """Decode payloads back to raw block bytes."""


class HostCodec(Codec):
    """A codec whose work runs on the host, in the native runtime or in
    Python, whatever ``device`` it was made for: the serial codecs, whose
    production route in the JAX package is its native batch drivers.
    One made for a CUDA device raises RuntimeError where there is none,
    so no call on ``cuda`` quietly runs on a machine without a card."""

    def __init__(self, config: CodecConfig, device="cuda"):
        super().__init__(config, device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{self.name} codec made for {self.device}, but no CUDA device is available"
            )
