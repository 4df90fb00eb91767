"""Host-side n-ary Huffman length computation (copy of
``data_compression_tpu/huffman/tree.py``: its tie-breaks decide the
wire bytes, so the two are held equal by tests/test_torch_host.py).

Reference analogue: ``generate_huffman_tree`` + ``summarize_tree_with_lengths``
(n_ary_huffman.c:868-1005, :1033-1093).  Differences, all deliberate:

* The reference finds the n smallest nodes with a repeated-pass bubble
  sort (``partial_sort``, n_ary_huffman.c:672-731) — O(k^2) per merge.
  We use a two-queue merge (sorted leaves + FIFO of internal nodes),
  O(k log k) total, the classic linear-time Huffman construction.
* The reference's dummy-node formula (n_ary_huffman.c:900-903) lacks a
  final modulo and trips its own assert at :916 whenever
  ``(k-1) % (n-1) == 0`` (e.g. trinary with an odd symbol count) — this
  is the bug that makes the reference binary SIGABRT on its smoke test.
  ``dummy_node_count`` applies the missing ``% (n-1)``.
* Tie-breaking matches the reference's *intended* behavior: its bubble
  sort is stable over the initial index order (leaves in symbol order,
  dummies after, internal nodes appended in creation order), so equal
  counts resolve by node seniority.  We key the merge queues the same
  way, giving deterministic, reproducible tables.

Only code *lengths* leave this module; actual codes come from
``canonical.lengths_to_codes`` so that table transmission is just the
length array, exactly as the reference's header intends
(n_ary_huffman.c:1736-1741 emits one digit per symbol length).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from data_compression_tpu_torch.config import MAX_CODE_LEN


def dummy_node_count(nonzero_symbols: int, arity: int) -> int:
    """Number of dummy leaves so that (k + d - 1) % (n - 1) == 0.

    Fixed version of n_ary_huffman.c:900-903 (adds the missing modulo).
    """
    if arity < 2:
        raise ValueError("arity must be >= 2")
    if nonzero_symbols <= 0:
        return 0
    n1 = arity - 1
    return (n1 - ((nonzero_symbols - 1) % n1)) % n1


def huffman_lengths(
    freqs: np.ndarray,
    arity: int,
    max_len: int = MAX_CODE_LEN,
) -> np.ndarray:
    """Optimal n-ary code lengths (in output digits) for each symbol.

    Args:
      freqs: [num_symbols] nonnegative counts. Zero-count symbols get
        length 0 (not encoded), mirroring the reference's zero-squeeze
        (n_ary_huffman.c:942-957).
      arity: number of output symbols n (2=binary, 3=trinary, ...).
      max_len: raise if any code would exceed this (the reference
        asserts max length < 16 at n_ary_huffman.c:1414).  When tripped,
        callers should rescale counts; with 64 KiB blocks and n>=2 the
        bound is unreachable for realistic data but kept as a guard.

    Returns:
      [num_symbols] int32 lengths.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    num_symbols = freqs.shape[0]
    lengths = np.zeros(num_symbols, dtype=np.int32)
    used = np.flatnonzero(freqs > 0)
    k = used.size
    if k == 0:
        return lengths
    if k == 1:
        # Degenerate single-symbol alphabet: the tree is a lone leaf and
        # the reference would emit a zero-length code; one digit is the
        # minimal decodable code.
        lengths[used[0]] = 1
        return lengths

    d = dummy_node_count(k, arity)
    # Leaves: real symbols in symbol order, then d dummies with count 1
    # (the reference gives dummies "minimum count" 1,
    # n_ary_huffman.c:921-929). Sort by (count, seniority); np.argsort
    # with kind="stable" preserves seniority among equal counts.
    counts = np.concatenate([freqs[used], np.ones(d, dtype=np.int64)])
    order = np.argsort(counts, kind="stable")
    leaf_q = deque((int(counts[i]), int(i)) for i in order)
    node_q: deque = deque()  # (count, id) — internal nodes in creation order

    # parent[i] for leaves 0..k+d-1 then internal nodes k+d...
    total_nodes = k + d + (k + d - 1) // (arity - 1)
    parent = np.full(total_nodes, -1, dtype=np.int64)
    next_id = k + d

    def pop_smallest():
        # Prefer the leaf on ties: leaves have smaller node ids than any
        # internal node (internal ids start at k+d), matching seniority.
        if leaf_q and (not node_q or leaf_q[0][0] <= node_q[0][0]):
            return leaf_q.popleft()
        return node_q.popleft()

    remaining = k + d
    while remaining > 1:
        total = 0
        for _ in range(arity):
            c, i = pop_smallest()
            parent[i] = next_id
            total += c
        node_q.append((total, next_id))
        next_id += 1
        remaining -= arity - 1
    assert not leaf_q and len(node_q) == 1

    # Depth of each real leaf = its code length.
    root = next_id - 1
    depth = np.zeros(total_nodes, dtype=np.int32)
    for i in range(root - 1, -1, -1):
        p = parent[i]
        if p >= 0:
            depth[i] = depth[p] + 1
    leaf_lengths = depth[:k]
    if leaf_lengths.max(initial=0) > max_len:
        raise ValueError(
            f"huffman code length {leaf_lengths.max()} exceeds max {max_len}; "
            "rescale frequencies"
        )
    lengths[used] = leaf_lengths
    return lengths
