"""Huffman chunk decode, n = 2, 3 and 16 (kernel: ``csrc/huffman_decode.cu``).

Replaces ``data_compression_tpu/ops/pallas/decode_kernel.py``
``_decode_pallas``.  Inputs, for K chunks of B blocks:

  flat [N] uint8 — every chunk's wire bytes, back to back (digit j of a
      chunk is digit j % D of its byte j // D, little-endian, D =
      ARITY_DIGITS_PER_BYTE[n]);
  chunk_off [K+1] int64 — chunk k is flat[chunk_off[k]:chunk_off[k+1]]
      (nondecreasing, within flat; checked on CUDA tensors, with one host
      read, unless the caller asks for no check: the kernel clamps every
      chunk into flat and every CTA's chunk range into [0, K] itself, so
      no offsets make it read outside its inputs);
  chunk_cnt [K] int32 — symbols in chunk k (at most C);
  chunk_blk [K] int32 — table row of chunk k, nondecreasing;
  limit, bmf [B, L+1] int32 (L = ARITY_MAX_LEN[n]: 15 at n = 2 and 3, 7
      at n = 16) and symbols [B, 256] int32 — the scaled decode tables of
      ``huffman.batched.decode_rows``.

Output: [K, C] uint8, chunk k's symbols in row k; bytes past
chunk_cnt[k] are undefined.

The kernel reads each code's length, rank and symbol from a per-block
table of ``LUT_DIGITS[n]``-digit window prefixes that it builds in
shared memory; ``decode_lut_ref`` builds the same table in plain
PyTorch for the tests.

``stages`` is ``_decode_pallas(stages=)``'s profiling ablation, in the
port's own loop (the TPU's boundary walk is this loop's consumption of
each code's digits, and its compaction has no counterpart).  At stages <
4 bytes 0..3 of row k hold, little-endian, the chunk's sum (mod 2**32)
of the stage's observable, read back by ``stage_sums``; the rest of the
row is undefined:
  1  window + length + walk: sum of the code lengths = the chunk's digits;
  2  + rank: sum of the ranks (a symbol's index in ``symbols``);
  3  + rank -> symbol: sum of the symbol bytes;
  4  the full kernel (the library path).
"""

from __future__ import annotations

import torch

from data_compression_tpu_torch.config import ARITY_DIGITS_PER_BYTE, ARITY_MAX_LEN, FAST_ARITIES
from data_compression_tpu_torch.ops.kernels import _build

_REF_BATCH = 32768  # chunks per step of the plain version (bounds memory)
DECODE_STAGES = (1, 2, 3, 4)
LUT_DIGITS = {2: 11, 16: 3, 3: 7}  # the kernel's table index: top K window digits (Arity<N>::kK)


def _check_stages(stages):
    if stages not in DECODE_STAGES:
        raise ValueError(f"decode stages must be one of {DECODE_STAGES}, got {stages!r}")


def stage_sums(out):
    """[K] int64: the stage observables in bytes 0..3 (little-endian) of
    each row of a stages < 4 decode output."""
    return sum(out[:, i].to(torch.int64) << (8 * i) for i in range(4))


def _check(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols, chunk_syms, arity):
    if arity not in FAST_ARITIES:
        raise ValueError(f"no decode kernel for arity {arity}")
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
    L = ARITY_MAX_LEN[arity]
    for name, t, w in (("limit", limit, L + 1), ("bmf", bmf, L + 1), ("symbols", symbols, 256)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B, w):
            raise ValueError(f"{name} must be [{B}, {w}] int32")
    C = chunk_syms
    if C < 16 or C & (C - 1):
        raise ValueError(f"chunk_syms {C} must be a power of two >= 16")
    return K, B, C


def decode_chunks_ref(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                      chunk_syms, arity=2, stages=4):
    """Plain PyTorch version (any device): the window / length / rank
    formulation of ``data_compression_tpu/ops/decode_fast.py`` (digits
    unpacked from each byte, the window a base-n Horner over L digits),
    with a Python loop over digit positions for the boundary walk.  At
    stages < 4 the observables are summed over each chunk's codeword
    starts; the rest of each row is 0."""
    K, B, C = _check(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                     chunk_syms, arity)
    _check_stages(stages)
    out = torch.zeros((K, C), dtype=torch.uint8, device=flat.device)
    for k0 in range(0, K, _REF_BATCH):
        k1 = min(K, k0 + _REF_BATCH)
        out[k0:k1] = _decode_ref_batch(
            flat, chunk_off[k0 : k1 + 1], chunk_cnt[k0:k1], chunk_blk[k0:k1],
            limit, bmf, symbols, C, arity, stages,
        )
    return out


def _decode_ref_batch(flat, off, cnt, blk, limit, bmf, symbols, C, n, stages):
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
    # stream digit t = digit t % D of byte t // D, weight n**(t % D)
    L, D = ARITY_MAX_LEN[n], ARITY_DIGITS_PER_BYTE[n]
    weight = n ** torch.arange(D, device=dev)
    digits = (pay[:, :, None] // weight) % n
    T = mb * D
    digits = torch.cat([digits.view(K, T), torch.zeros((K, L), dtype=torch.int64, device=dev)], 1)
    W = torch.zeros((K, T), dtype=torch.int64, device=dev)
    for i in range(L):
        W = W * n + digits[:, i : i + T]
    lim = limit.to(torch.int64)[blk.long()]  # [K, L+1]
    ln = torch.ones((K, T), dtype=torch.int64, device=dev)
    for l in range(1, L):
        ln += (W >= lim[:, l : l + 1]).to(torch.int64)
    bm = torch.gather(bmf.to(torch.int64)[blk.long()], 1, ln)
    scale = n ** (L - torch.arange(L + 1, device=dev))  # n**(L - ln), by ln
    rank = (bm + W // scale[ln]) & 0xFF
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
    if stages < 4:
        v = (ln, rank, sym)[stages - 1]
        sums = torch.where(mask, v, 0).sum(1) & 0xFFFFFFFF
        for i in range(4):
            out[:, i] = ((sums >> (8 * i)) & 0xFF).to(torch.uint8)
        return out
    kk, tt = mask.nonzero(as_tuple=True)
    out[kk, bidx[kk, tt]] = sym[kk, tt].to(torch.uint8)
    return out


def decode_lut_ref(limit, bmf, symbols, arity):
    """The kernel's per-block table of k-digit window prefixes (k =
    ``LUT_DIGITS[arity]``), in plain PyTorch, for tests: [B, arity**k]
    int64 entries packed as the kernel packs them (symbol byte
    | rank << 8 | ln << 16 | top << 20, ``top`` the prefix's first ln
    digits), or 0, the marker that sends a window to the compare chain.
    Prefix p covers W in [p * n**(L-k), (p+1) * n**(L-k) - 1]; its entry
    is exact when the chain gives one ln <= k at both ends (ln is
    nondecreasing in W for any limits).  Limits compare as uint32, as in
    the kernel."""
    n, L, k = arity, ARITY_MAX_LEN[arity], LUT_DIGITS[arity]
    dev = limit.device
    lim = limit.to(torch.int64) & 0xFFFFFFFF
    span = n ** (L - k)
    lo = torch.arange(n**k, dtype=torch.int64, device=dev) * span

    def chain(W):
        return 1 + (W[None, :, None] >= lim[:, None, 1:L]).sum(-1)

    ln = chain(lo)
    exact = (ln <= k) & (chain(lo + span - 1) == ln)
    top = lo[None, :] // (n ** (L - ln))
    rank = (torch.gather(bmf.to(torch.int64), 1, ln) + top) & 0xFF
    sym = torch.gather(symbols.to(torch.int64), 1, rank) & 0xFF
    return torch.where(exact, sym | rank << 8 | ln << 16 | top << 20, 0)


def decode_launcher(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                    chunk_syms, arity=2, check=True):
    """Check the inputs once and return ``launch(stages=4)``, which
    decodes them on their device: the CUDA kernel for CUDA tensors (no
    further checks and no host sync per call, for timing loops), the
    plain version for CPU tensors.  ``launch`` -> [K, C] uint8.  On CUDA
    tensors the offsets and table rows are checked with one host read
    (ValueError when a chunk leaves flat or the rows are out of order);
    ``check=False`` skips that read, and chunks out of flat then decode
    from their bytes inside it (the kernel's clamps)."""
    if flat.device.type == "cpu":
        def launch_ref(stages=4):
            return decode_chunks_ref(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf,
                                     symbols, chunk_syms, arity, stages)
        return launch_ref
    K, B, C = _check(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                     chunk_syms, arity)
    _build.require_cuda(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols)
    dev = flat.device
    blk_start = None
    if K and B:
        if check:
            bad = ((chunk_off[0] < 0) | (chunk_off[-1] > flat.numel())
                   | (chunk_off.diff() < 0).any())
            bad |= (chunk_blk[0] < 0) | (chunk_blk[-1] >= B) | (chunk_blk.diff() < 0).any()
            if bool(bad):
                raise ValueError("chunk_off must be nondecreasing within flat and "
                                 "chunk_blk nondecreasing within [0, B)")
        # chunks of table row b are [blk_start[b], blk_start[b+1])
        blk_start = torch.searchsorted(
            chunk_blk, torch.arange(B + 1, dtype=torch.int32, device=dev)
        )

    def launch(stages=4):
        _check_stages(stages)
        out = torch.empty((K, C), dtype=torch.uint8, device=dev)
        if blk_start is not None:
            with torch.cuda.device(dev):
                rc = _build.lib().dct_huffman_decode(
                    flat.data_ptr(), chunk_off.data_ptr(), chunk_cnt.data_ptr(),
                    blk_start.data_ptr(), limit.data_ptr(), bmf.data_ptr(),
                    symbols.data_ptr(), out.data_ptr(), B, C, arity, stages, flat.numel(), K,
                    _build.stream_of(flat),
                )
            _build.check(rc, "huffman_decode")
            decode_chunks.launches += 1
        return out

    return launch


def decode_chunks(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                  chunk_syms, arity=2, stages=4):
    """Decode on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  -> [K, C] uint8."""
    _check_stages(stages)
    return decode_launcher(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                           chunk_syms, arity)(stages)


decode_chunks.launches = 0
