"""Plain n-ary canonical Huffman with per-block tables, the reference that
decides ``correct``.  Plain PyTorch on any device; it imports nothing of
the program under test and takes nothing it made.

The wire format it writes (the container's Huffman block payload): block
b's symbols are cut into chunks of C; chunk k holds symbols [k*C,
(k+1)*C) of the block's valid prefix, each as its canonical code's base-n
digits, most significant first; stream digit j of a chunk is digit j % D
of the chunk's byte j // D, weight n**(j % D) (D = the most base-n digits
a byte holds), the last byte zero-padded, so a chunk takes ceil(digits /
D) wire bytes.  The payload is every block's chunks back to back, in
block order.  A block's table travels as its row of 256 code lengths.

``code_lengths`` is a frozen copy of the program's plain table build
(``ops/kernels/table_build.py`` ``_build_once_ref`` and
``huffman_lengths_ref``): leaves keyed on (count, seniority) with the
n-ary dummies of count 1 after the used symbols, the leaf taken on a tie,
internal nodes first in first out; while a block's longest code exceeds
the cap, its nonzero counts become (c + 1) // 2 and it is built again.
Canonical codes: symbols ordered by (length, symbol), first code of
length l+1 = (first code of length l + symbols of length l) * n.
"""

from __future__ import annotations

import torch

ALPHABET = 256
_MAXD = 64  # >= arity - 2 dummy leaves
_NL = ALPHABET + _MAXD
_INF = 1 << 62
_SEN_BITS = 9


def digits_per_byte(n: int) -> int:
    """Largest D with n**D <= 256."""
    d = 1
    while n ** (d + 1) <= 256:
        d += 1
    return d


def histograms(raw: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[B, 256] int64 counts of each block's bytes before its length."""
    B, S = raw.shape
    idx = raw.to(torch.int64) + torch.arange(B, device=raw.device)[:, None] * ALPHABET
    valid = torch.arange(S, device=raw.device)[None, :] < lens.to(torch.int64)[:, None]
    idx = torch.where(valid, idx, B * ALPHABET)
    return torch.bincount(idx.view(-1), minlength=B * ALPHABET + 1)[:-1].view(B, ALPHABET)


def _build_once(f: torch.Tensor, n: int) -> torch.Tensor:
    """Uncapped lengths [B, 256] int64 of the counts ``f`` [B, 256] int64."""
    B, dev = f.shape[0], f.device
    n1 = n - 1
    T = (_NL - 1) // n1
    used = f > 0
    k = used.sum(1)
    d = torch.where(k > 0, (n1 - (k - 1) % n1) % n1, 0)
    rank = torch.cumsum(used, 1) - 1
    real_key = torch.where(used, (f << _SEN_BITS) + rank, _INF)
    j = torch.arange(_MAXD, device=dev)[None, :]
    dummy_key = torch.where(j < d[:, None], (1 << _SEN_BITS) + k[:, None] + j, _INF)
    keys = torch.sort(torch.cat([real_key, dummy_key], 1), 1).values
    in_tree = torch.arange(_NL, device=dev)[None, :] < (k + d)[:, None]
    leaf_cnt = torch.where(in_tree, keys >> _SEN_BITS, _INF)
    leaf_sen = torch.where(in_tree, keys & ((1 << _SEN_BITS) - 1), (1 << _SEN_BITS) - 1)

    b = torch.arange(B, device=dev)
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    lp, nh, nt = zeros.clone(), zeros.clone(), zeros.clone()
    remaining = k + d
    node_cnt = torch.full((B, T + 1), _INF, dtype=torch.int64, device=dev)
    parent = torch.full((B, _NL + T + 1), -1, dtype=torch.int64, device=dev)
    for _ in range(T):
        active = remaining > 1
        total = zeros.clone()
        for _ in range(n):
            lc = torch.where(lp < _NL, leaf_cnt.gather(1, lp.clamp(max=_NL - 1)[:, None])[:, 0],
                             _INF)
            nc = torch.where(nh < nt, node_cnt.gather(1, nh[:, None])[:, 0], _INF)
            pick_leaf = lc <= nc
            child = torch.where(active, torch.where(pick_leaf, lp, _NL + nh), _NL + T)
            parent[b, child] = _NL + nt
            total += torch.where(active, torch.minimum(lc, nc), 0)
            lp += active & pick_leaf
            nh += active & ~pick_leaf
        node_cnt[b, torch.where(active, nt, T)] = total
        nt += active
        remaining -= torch.where(active, n1, 0)

    depth = torch.zeros((B, _NL + T + 1), dtype=torch.int64, device=dev)
    for t in range(T - 1, -1, -1):
        p = parent[:, _NL + t]
        depth[:, _NL + t] = torch.where(p >= 0, depth.gather(1, p.clamp(min=0)[:, None])[:, 0] + 1,
                                        0)
    pl = parent[:, :_NL]
    leaf_depth = torch.where(pl >= 0, depth.gather(1, pl.clamp(min=0)) + 1, 0)
    pos_of_sen = torch.zeros((B, 1 << _SEN_BITS), dtype=torch.int64, device=dev)
    pos_of_sen.scatter_(1, leaf_sen, torch.arange(_NL, device=dev).expand(B, _NL))
    lengths = leaf_depth.gather(1, pos_of_sen.gather(1, rank.clamp(min=0)))
    lengths = torch.where(used, lengths, 0)
    return torch.where(used & (k == 1)[:, None], 1, lengths)


def code_lengths(hists: torch.Tensor, n: int, cap: int) -> torch.Tensor:
    """[B, 256] int32 code lengths in base-n digits, none above ``cap``."""
    f = hists.to(torch.int64)
    lengths = _build_once(f, n)
    while True:
        over = lengths.max(1).values > cap if lengths.numel() else lengths.new_zeros(0).bool()
        if not bool(over.any()):
            return lengths.to(torch.int32)
        f = torch.where(over[:, None] & (f > 0), (f + 1) // 2, f)
        lengths = torch.where(over[:, None], _build_once(f, n), lengths)


def _per_length(lengths: torch.Tensor, n: int, L: int):
    """Per block and length l = 0..L, int64 [B, L+1]: (count, first code)."""
    lv = torch.arange(L + 1, device=lengths.device)
    count = (lengths.to(torch.int64)[:, :, None] == lv[1:]).sum(1)
    count = torch.cat([torch.zeros_like(count[:, :1]), count], 1)
    first = torch.zeros_like(count)
    for l in range(1, L):
        first[:, l + 1] = (first[:, l] + count[:, l]) * n
    return count, first


def canonical_codes(lengths: torch.Tensor, n: int, L: int) -> torch.Tensor:
    """[B, 256] int64 canonical codes of the length rows (0 where unused)."""
    ln = lengths.to(torch.int64)
    count, first = _per_length(ln, n, L)
    lv = torch.arange(L + 1, device=ln.device)
    onehot = (ln[:, :, None] == lv).to(torch.int64)
    rank = (torch.cumsum(onehot, 1) - onehot).gather(2, ln[:, :, None])[:, :, 0]
    return torch.where(ln > 0, first.gather(1, ln) + rank, 0)


def encode(raw: torch.Tensor, lens: torch.Tensor, lengths: torch.Tensor, n: int, C: int,
           blocks_per_step: int = 256):
    """Encode [B, S] uint8 blocks (valid up to ``lens``) with the per-block
    length rows ``lengths`` [B, 256] (a row may serve every block when B
    rows are given alike).  -> (payload [total] uint8, chunk wire bytes
    [B, S/C] int32).

    A symbol whose code digits start at stream digit f adds, to the
    chunk's stream read as one base-n number, its code with the digits
    reversed times n**f.  No two symbols share a digit, so the sums never
    carry: byte j of the stream is the base-n**D digit j of that number,
    and each symbol touches at most ceil((D - 1 + length) / D) bytes."""
    B, S = raw.shape
    ncb = S // C
    D = digits_per_byte(n)
    base = n ** D
    dev = raw.device
    ln_tab = lengths.to(torch.int64)
    L = max(int(ln_tab.max()) if ln_tab.numel() else 1, 1)
    codes = canonical_codes(lengths, n, L)
    m = torch.arange(L, device=dev)
    place = (ln_tab[:, :, None] - 1 - m).clamp(min=0)
    digit = torch.where(m < ln_tab[:, :, None], codes[:, :, None] // n ** place % n, 0)
    reversed_code = (digit * n ** m).sum(-1).view(B * ALPHABET)
    pos = torch.arange(S, device=dev)[None, :]
    chunk_digits = torch.empty((B, ncb), dtype=torch.int64, device=dev)
    for b0 in range(0, B, blocks_per_step):
        b1 = min(B, b0 + blocks_per_step)
        nd = ln_tab[b0:b1].gather(1, raw[b0:b1].to(torch.int64))
        nd = torch.where(pos < lens[b0:b1].to(torch.int64)[:, None], nd, 0)
        chunk_digits[b0:b1] = nd.view(b1 - b0, ncb, C).sum(-1)
    chunk_bytes = (chunk_digits + D - 1) // D
    ends = torch.cumsum(chunk_bytes.view(-1), 0)
    starts = (ends - chunk_bytes.view(-1)).view(B, ncb)
    total = int(ends[-1]) if ends.numel() else 0
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    spans = -(-(D - 1 + L) // D)
    for b0 in range(0, B, blocks_per_step):
        b1 = min(B, b0 + blocks_per_step)
        nb = b1 - b0
        byte0 = int(starts[b0, 0]) if ncb else 0
        span = int(ends.view(B, ncb)[b1 - 1, -1]) - byte0 if ncb else 0
        sym = raw[b0:b1].to(torch.int64)
        nd = ln_tab[b0:b1].gather(1, sym)
        nd = torch.where(pos < lens[b0:b1].to(torch.int64)[:, None], nd, 0)
        nd3 = nd.view(nb, ncb, C)
        first = ((starts[b0:b1] - byte0) * D)[:, :, None] + torch.cumsum(nd3, -1) - nd3
        first = first.view(nb, S)
        at, shift = first // D, first % D
        val = reversed_code[sym + torch.arange(b0, b1, device=dev)[:, None] * ALPHABET]
        val = torch.where(nd > 0, val * n ** shift, 0)
        acc = torch.zeros(span + 1, dtype=torch.int64, device=dev)  # + one dump byte
        for k in range(spans):
            touches = (nd > 0) & (k * D < shift + nd)
            acc.index_add_(0, torch.where(touches, at + k, span).view(-1),
                           (val // base ** k % base).view(-1))
        out[byte0:byte0 + span] = acc[:span].to(torch.uint8)
    return out, chunk_bytes.to(torch.int32)


def decode_tables(lengths: torch.Tensor, n: int, L: int):
    """Per block, int64: (limit [B, L+1], first [B, L+1], base [B, L+1],
    symbols [B, 256]): a code of length l spans the L-digit windows W with
    limit[l-1] <= W < limit[l]; its symbol is symbols[base[l] + W //
    n**(L-l) - first[l]] (symbols ordered by (length, symbol))."""
    ln = lengths.to(torch.int64)
    count, first = _per_length(ln, n, L)
    lv = torch.arange(L + 1, device=ln.device)
    limit = torch.cumsum(count * n ** (L - lv), 1)
    base = torch.cumsum(count, 1) - count
    sym = torch.arange(ALPHABET, device=ln.device)
    symbols = torch.argsort(torch.where(ln > 0, ln * 512 + sym, 1 << 20), 1)
    return limit, first, base, symbols


def decode(payload: torch.Tensor, chunk_bytes: torch.Tensor, chunk_syms: torch.Tensor,
           lengths: torch.Tensor, n: int, C: int, L: int,
           chunks_per_step: int = 16384) -> torch.Tensor:
    """Decode every chunk: ``chunk_bytes`` [B, S/C] wire bytes (back to
    back in ``payload``), ``chunk_syms`` [B, S/C] symbols of each chunk,
    ``lengths`` [B, 256] the blocks' length rows, none above ``L``.  -> [B, S]
    uint8, zeros past each chunk's symbols."""
    B, ncb = chunk_bytes.shape
    K = B * ncb
    D = digits_per_byte(n)
    dev = payload.device
    limit, first, base, symbols = decode_tables(lengths, n, L)
    nbytes = chunk_bytes.reshape(-1).to(torch.int64)
    starts = torch.cumsum(nbytes, 0) - nbytes
    cnt = chunk_syms.reshape(-1).to(torch.int64)
    blk = torch.arange(K, device=dev) // ncb
    out = torch.zeros((K, C), dtype=torch.uint8, device=dev)
    weight = n ** torch.arange(D, device=dev)
    scale = n ** (L - torch.arange(L + 1, device=dev))
    src = torch.cat([payload.to(torch.int64), payload.new_zeros(1).to(torch.int64)])
    for k0 in range(0, K, chunks_per_step):
        k1 = min(K, k0 + chunks_per_step)
        kk = k1 - k0
        mb = max(int(nbytes[k0:k1].max()), 1)
        j = torch.arange(mb, device=dev)
        inb = j[None, :] < nbytes[k0:k1, None]
        idx = torch.where(inb, starts[k0:k1, None] + j[None, :], payload.numel())
        digits = (src[idx][:, :, None] // weight % n).view(kk, mb * D)
        T = mb * D
        digits = torch.cat([digits, digits.new_zeros(kk, L)], 1)
        W = torch.zeros((kk, T), dtype=torch.int64, device=dev)
        for i in range(L):
            W = W * n + digits[:, i:i + T]
        del digits
        b = blk[k0:k1]
        lim = limit[b]
        ln = torch.ones((kk, T), dtype=torch.int64, device=dev)
        for l in range(1, L):
            ln += W >= lim[:, l:l + 1]
        at = torch.zeros(kk, dtype=torch.int64, device=dev)
        rows = torch.empty((kk, C), dtype=torch.int64, device=dev)
        first_b, base_b, sym_b = first[b], base[b], symbols[b]
        for i in range(C):
            a = at.clamp(max=T - 1)[:, None]
            l = ln.gather(1, a)
            w = W.gather(1, a)
            rank = base_b.gather(1, l) + w // scale[l] - first_b.gather(1, l)
            rows[:, i] = sym_b.gather(1, rank.clamp(0, ALPHABET - 1))[:, 0]
            at = at + l[:, 0]
        keep = torch.arange(C, device=dev)[None, :] < cnt[k0:k1, None]
        out[k0:k1] = torch.where(keep, rows, 0).to(torch.uint8)
    return out.view(B, ncb * C)
