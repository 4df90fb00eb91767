"""Inputs shared by the port's CPU and card tests (no JAX here: the card
tests import this module on a machine without it)."""

import numpy as np

from data_compression_tpu_torch.utils.corpora import enwik_like


def hist_blocks(kind, B, S, seed):
    """([B, S] uint8 blocks, [B] int64 lengths) of one histogram case:
    rows of text, all zeros, all 255 and random bytes in turn, the lengths
    S, 0, 1, S - 1 and random in turn ("edges"), or full ("full")."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(enwik_like(S, seed), np.uint8)
    rows = [text, np.zeros(S, np.uint8), np.full(S, 255, np.uint8),
            rng.integers(0, 256, S, dtype=np.uint8)]
    blocks = np.stack([rows[i % 4] for i in range(B)])
    if kind == "full":
        return blocks, np.full(B, S, np.int64)
    picks = [S, 0, 1, S - 1]
    lengths = np.array([picks[i % 5] if i % 5 < 4 else int(rng.integers(0, S + 1))
                        for i in range(B)], np.int64)
    return blocks, lengths
