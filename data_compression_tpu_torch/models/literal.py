"""LITERAL pass-through codec (copy of ``data_compression_tpu/models/literal.py``).

Every reference scheme has a mandatory pass-through fallback when
compression does not win (nybble_compression.c:1018-1037,
small_compression.c:651-664, n_ary_huffman.c:1806-1814).  Here the
fallback is framed per block (flag bit) rather than with a type byte, so
it is binary-safe; this codec also stands alone as the identity codec.
It runs on the host whatever its device (``HostCodec``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from data_compression_tpu_torch.models.base import EncodeResult, HostCodec


class LiteralCodec(HostCodec):
    name = "literal"

    def encode_blocks(self, blocks: np.ndarray, lengths: np.ndarray) -> EncodeResult:
        payloads = [
            blocks[i, : int(lengths[i])].tobytes() for i in range(blocks.shape[0])
        ]
        return EncodeResult(payloads=payloads)

    def decode_blocks(
        self,
        payloads: List[bytes],
        raw_lens: List[int],
        shared_table: Optional[bytes] = None,
    ) -> List[bytes]:
        for p, r in zip(payloads, raw_lens):
            if len(p) != r:
                raise ValueError("literal payload length mismatch")
        return list(payloads)
