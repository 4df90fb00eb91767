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


def _require_card(codec: Codec) -> None:
    """RuntimeError for a codec made for a CUDA device where there is
    none, so no call on ``cuda`` quietly runs on a machine without a card."""
    if codec.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{codec.name} codec made for {codec.device}, but no CUDA device is available"
        )


class HostCodec(Codec):
    """A codec whose work runs on the host whatever ``device`` it was made
    for: ``literal``, a pass-through with no work a card could take."""

    def __init__(self, config: CodecConfig, device="cuda"):
        super().__init__(config, device)
        _require_card(self)


class LaneCodec(Codec):
    """A serial codec (``nybble``, ``small_byte``, ``small_nybble``).  On a
    CUDA device its blocks go through the lanes of ``ops/scan_codecs.py``
    (one CUDA thread or warp per block); on the CPU through the native
    runtime's OpenMP batch drivers, the JAX package's production route.
    Both give the same payloads."""

    def __init__(self, config: CodecConfig, device="cuda"):
        super().__init__(config, device)
        _require_card(self)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"
