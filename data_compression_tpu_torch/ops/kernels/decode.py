"""Huffman chunk decode, n = 2 (kernel: ``csrc/huffman_decode.cu``).

Replaces ``data_compression_tpu/ops/pallas/decode_kernel.py``
``_decode_pallas``.  Inputs, for K chunks of B blocks:

  flat [N] uint8 — every chunk's wire bytes, back to back;
  chunk_off [K+1] int64 — chunk k is flat[chunk_off[k]:chunk_off[k+1]]
      (nondecreasing, within flat; checked on CUDA tensors);
  chunk_cnt [K] int32 — symbols in chunk k (at most C);
  chunk_blk [K] int32 — table row of chunk k, nondecreasing;
  limit, bmf [B, 16] int32 and symbols [B, 256] int32 — the scaled decode
      tables of ``huffman.batched.decode_rows``.

Output: [K, C] uint8, chunk k's symbols in row k; bytes past
chunk_cnt[k] are undefined.
"""

from __future__ import annotations

import torch

from data_compression_tpu_torch.config import ARITY_MAX_LEN
from data_compression_tpu_torch.ops.kernels import _build

_L = ARITY_MAX_LEN[2]
_REF_BATCH = 32768  # chunks per step of the plain version (bounds memory)


def _check(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols, chunk_syms):
    K = chunk_cnt.shape[0] if chunk_cnt.dim() == 1 else -1
    if flat.dtype != torch.uint8 or flat.dim() != 1:
        raise ValueError("flat must be a 1-D uint8 tensor")
    if chunk_off.dtype != torch.int64 or tuple(chunk_off.shape) != (K + 1,):
        raise ValueError("chunk_off must be [K+1] int64")
    if chunk_cnt.dtype != torch.int32 or chunk_blk.dtype != torch.int32:
        raise ValueError("chunk_cnt and chunk_blk must be int32")
    if tuple(chunk_blk.shape) != (K,):
        raise ValueError("chunk_blk must be [K]")
    B = limit.shape[0]
    for name, t, w in (("limit", limit, _L + 1), ("bmf", bmf, _L + 1), ("symbols", symbols, 256)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B, w):
            raise ValueError(f"{name} must be [{B}, {w}] int32")
    C = chunk_syms
    if C < 16 or C & (C - 1):
        raise ValueError(f"chunk_syms {C} must be a power of two >= 16")
    return K, B, C


def decode_chunks_ref(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                      chunk_syms):
    """Plain PyTorch version (any device): the window / length / rank
    formulation of ``data_compression_tpu/ops/decode_fast.py``, with a
    Python loop over digit positions for the boundary walk."""
    K, B, C = _check(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                     chunk_syms)
    out = torch.zeros((K, C), dtype=torch.uint8, device=flat.device)
    for k0 in range(0, K, _REF_BATCH):
        k1 = min(K, k0 + _REF_BATCH)
        out[k0:k1] = _decode_ref_batch(
            flat, chunk_off[k0 : k1 + 1], chunk_cnt[k0:k1], chunk_blk[k0:k1],
            limit, bmf, symbols, C,
        )
    return out


def _decode_ref_batch(flat, off, cnt, blk, limit, bmf, symbols, C):
    dev = flat.device
    K = cnt.shape[0]
    nb = off[1:] - off[:-1]
    mb = int(nb.max()) if K else 0
    out = torch.zeros((K, C), dtype=torch.uint8, device=dev)
    if mb == 0:
        # no payload bytes: every window reads zeros
        mb = 1
    j = torch.arange(mb, device=dev)
    inb = j[None, :] < nb[:, None]
    idx = torch.where(inb, off[:-1, None] + j[None, :], 0)
    src = flat if flat.numel() else torch.zeros(1, dtype=torch.uint8, device=dev)
    pay = torch.where(inb, src[idx], 0).to(torch.int64)  # [K, mb]
    # stream digit t = bit (t & 7) of byte (t >> 3); int64 shifts only
    bits = (pay[:, :, None] >> torch.arange(8, device=dev)) & 1
    T = mb * 8
    bits = torch.cat([bits.view(K, T), torch.zeros((K, _L), dtype=torch.int64, device=dev)], 1)
    W = torch.zeros((K, T), dtype=torch.int64, device=dev)
    for i in range(_L):
        W = (W << 1) | bits[:, i : i + T]
    lim = limit.to(torch.int64)[blk.long()]  # [K, L+1]
    ln = torch.ones((K, T), dtype=torch.int64, device=dev)
    for l in range(1, _L):
        ln += (W >= lim[:, l : l + 1]).to(torch.int64)
    bm = torch.gather(bmf.to(torch.int64)[blk.long()], 1, ln)
    rank = (bm + (W >> (_L - ln))) & 0xFF
    # boundary walk: distance to the next codeword start
    lnT = ln.t().contiguous()
    maskT = torch.empty((T, K), dtype=torch.bool, device=dev)
    dist = torch.zeros((K,), dtype=torch.int64, device=dev)
    for t in range(T):
        at = dist == 0
        maskT[t] = at
        dist = torch.where(at, lnT[t] - 1, dist - 1)
    mask = maskT.t()
    bidx = torch.cumsum(mask.to(torch.int64), 1) - mask.to(torch.int64)
    mask = mask & (bidx < cnt.to(torch.int64).clamp(0, C)[:, None])
    sym = torch.gather(symbols.to(torch.int64)[blk.long()], 1, rank)
    kk, tt = mask.nonzero(as_tuple=True)
    out[kk, bidx[kk, tt]] = sym[kk, tt].to(torch.uint8)
    return out


def decode_chunks(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                  chunk_syms):
    """Decode on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  -> [K, C] uint8."""
    if flat.device.type == "cpu":
        return decode_chunks_ref(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf,
                                 symbols, chunk_syms)
    K, B, C = _check(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                     chunk_syms)
    _build.require_cuda(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols)
    dev = flat.device
    out = torch.empty((K, C), dtype=torch.uint8, device=dev)
    if K and B:
        # the kernel reads flat[chunk_off[k]:chunk_off[k+1]] unchecked
        bad = (chunk_off[0] < 0) | (chunk_off[-1] > flat.numel()) | (chunk_off.diff() < 0).any()
        bad |= (chunk_blk[0] < 0) | (chunk_blk[-1] >= B) | (chunk_blk.diff() < 0).any()
        if bool(bad):
            raise ValueError("chunk_off must be nondecreasing within flat and "
                             "chunk_blk nondecreasing within [0, B)")
        # chunks of table row b are [blk_start[b], blk_start[b+1])
        blk_start = torch.searchsorted(
            chunk_blk, torch.arange(B + 1, dtype=torch.int32, device=dev)
        )
        with torch.cuda.device(dev):
            rc = _build.lib().dct_huffman_decode(
                flat.data_ptr(), chunk_off.data_ptr(), chunk_cnt.data_ptr(),
                blk_start.data_ptr(), limit.data_ptr(), bmf.data_ptr(),
                symbols.data_ptr(), out.data_ptr(), B, C, _build.stream_of(flat),
            )
        _build.check(rc, "huffman_decode")
        decode_chunks.launches += 1
    return out


decode_chunks.launches = 0
