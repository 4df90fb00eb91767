"""Compact kernel module: the plain version ``compact_blocks_ref``
against the TPU kernel ``compact_block_rows`` (Pallas interpret mode on
the CPU) fed the same rows.  The TPU kernel places blocks at 4 KiB-aligned
starts and the port at tight ones, so each block's valid slice is
compared.  Tolerance: exact bytes.
"""

import numpy as np
import pytest
import torch

from data_compression_tpu_torch.ops.kernels import compact as kcmp


def test_compact_ref_matches_pallas_compact_block_rows():
    import jax.numpy as jnp

    from data_compression_tpu.ops.pallas.compact_kernel import ALIGN, compact_block_rows

    rng = np.random.default_rng(17)
    B, NW = 4, 2 * ALIGN  # int32 words per row
    rows_w = rng.integers(-(2**31), 2**31, size=(B, NW), dtype=np.int64).astype(np.int32)
    block_bytes = np.array([5000, 0, 8192, 1], np.int64)
    padded_w = -(-block_bytes // 4096) * ALIGN
    starts_w = np.concatenate([[0], np.cumsum(padded_w)[:-1]]).astype(np.int32)
    out_cap_w = int(padded_w.sum())
    j_flat = np.asarray(
        compact_block_rows(jnp.asarray(rows_w), jnp.asarray(starts_w), out_cap_w,
                           interpret=True)
    ).view(np.uint8)

    rows = torch.from_numpy(rows_w.view(np.uint8).reshape(B, -1).copy())
    flat = kcmp.compact_blocks_ref(rows, torch.from_numpy(block_bytes.astype(np.int32)))
    flat = flat.numpy()
    assert flat.shape == (int(block_bytes.sum()),)
    tight = np.concatenate([[0], np.cumsum(block_bytes)])
    for b in range(B):
        n = int(block_bytes[b])
        got = flat[tight[b] : tight[b] + n]
        want = j_flat[starts_w[b] * 4 : starts_w[b] * 4 + n]
        assert got.tobytes() == want.tobytes(), f"block {b}"
        assert got.tobytes() == rows[b, :n].numpy().tobytes()


def test_compact_wrapper_cpu_dispatch_and_checks():
    rows = torch.arange(24, dtype=torch.uint8).reshape(3, 8)
    bb = torch.tensor([2, 0, 3], dtype=torch.int32)
    before = kcmp.compact_blocks.launches
    assert kcmp.compact_blocks(rows, bb).tolist() == [0, 1, 16, 17, 18]
    assert kcmp.compact_blocks.launches == before
    empty = kcmp.compact_blocks(rows[:0], bb[:0])
    assert empty.dtype == torch.uint8 and empty.numel() == 0
    with pytest.raises(ValueError):
        kcmp.compact_blocks(rows, bb.long())
    with pytest.raises(ValueError):
        kcmp.compact_blocks(rows.int(), bb)
