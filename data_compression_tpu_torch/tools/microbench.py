"""Microbenchmarks of the table-lookup formulations on a CUDA device.

    python -m data_compression_tpu_torch.tools.microbench [--device cuda]
    python -m data_compression_tpu_torch.tools.microbench --smoke [--device cpu]

Counterpart of the JAX package's ``tools/microbench.py``: the ten
variants of ``ops/kernels/microbench.py`` over the same [B, C, 128]
uint8 symbol tensor (B = 128, C = 512: 8 MiB) and the same tables
(``default_rng(1)``: [B, 2, 128] int32 < 2**19, [B, 6, 128] uint8,
[B, 4, 128] int16 < 2**15; symbols from ``default_rng(0)``).

8 MiB in and 8 MiB out fit in the H100's 50 MB L2, so launches back to
back would read from L2.  Each launch is timed instead between its own
CUDA events after a 256 MiB scratch buffer is rewritten outside them
(``timing.cold_ms``): ``ms`` is the median of 30 launches with the
input cold in L2, ``gbps`` the symbol bytes over it.  Prints a
header line, then one JSON line per variant, ``{"variant", "ms",
"gbps"}``, with ``library_ms`` for every variant but ``gather256_u8_x3``
and ``stage1_like`` (``library_call``: ``Tensor.copy_`` for
``passthrough`` and ``widen_i32``, else ``torch.gather`` on the flattened
table narrowed to uint8, writing the same 8 MiB uint8 result).

``--smoke`` runs every variant at B = 2 on ``--device`` (default cuda,
as every entry point; ``--device cpu`` runs the plain versions) against
its plain version, times nothing, and prints
``{"smoke": true, "variants": 10, "ok": true}`` last.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from data_compression_tpu_torch.ops.kernels import microbench as kmb
from data_compression_tpu_torch.tools import timing

B = 128
C = 512
LANES = kmb.LANES
# variants with one PyTorch call that computes the same function
# (the x3 variant takes three lookups, stage1_like a lane mask as well)
LIBRARY_VARIANTS = tuple(v for v in kmb.VARIANTS if v not in ("gather256_u8_x3", "stage1_like"))


def make_inputs(batch: int, device):
    """(s [batch, C, 128] uint8, {variant: its table or None}) on
    ``device``, seeded as the JAX tool seeds them."""
    rng = np.random.default_rng(1)
    table32 = rng.integers(0, 2**19, (batch, 2, LANES), np.int32)
    table8 = rng.integers(0, 256, (batch, 6, LANES), np.uint8)
    table16 = rng.integers(0, 2**15, (batch, 4, LANES), np.int16)
    s = np.random.default_rng(0).integers(0, 256, (batch, C, LANES), np.uint8)
    by_dtype = {torch.int32: table32, torch.uint8: table8, torch.int16: table16}
    tables = {
        name: None if spec is None else torch.from_numpy(by_dtype[spec[0]]).to(device)
        for name, spec in kmb.TABLES.items()
    }
    return torch.from_numpy(s).to(device), tables


def library_call(name, s, table):
    """A zero-argument PyTorch call computing variant ``name`` on these
    inputs into a [B, C, 128] uint8 result, as the kernel does, or None
    where no single call does.  ``passthrough`` and ``widen_i32`` are the
    identity on uint8 (``Tensor.copy_``); a lookup is ``torch.gather``
    from the table narrowed to its low bytes.  The int64 index, the
    narrowed table and the result are made here, outside the call."""
    if name not in LIBRARY_VARIANTS:
        return None
    dst = torch.empty_like(s)
    if table is None:
        return lambda: dst.copy_(s)
    B = s.shape[0]
    idx = s.reshape(B, -1).long()
    entries = 128 if name == "gather128_i32_single" else 256
    narrow = (table.reshape(B, -1)[:, :entries] & 0xFF).to(torch.uint8)
    idx &= entries - 1
    out = dst.view(B, -1)
    return lambda: torch.gather(narrow, 1, idx, out=out)


def table_bytes(table) -> int:
    return 0 if table is None else table.numel() * table.element_size()


def run(device="cuda", reps: int = 30):
    """Time every variant, each the median of ``reps`` launches; -> one
    dict per variant."""
    dev = timing.require_cuda(device)
    s, tables = make_inputs(B, dev)
    nbytes = s.numel()
    results = []
    for name in kmb.VARIANTS:
        table = tables[name]
        ms = timing.cold_ms(lambda: kmb.lookup_variant(name, s, table), reps, dev)
        r = {"variant": name, "ms": ms, "gbps": nbytes / (ms * 1e-3) / 1e9}
        lib = library_call(name, s, table)
        if lib is not None:
            r["library_ms"] = timing.cold_ms(lib, reps, dev)
        results.append(r)
    return results


def smoke(device="cuda") -> bool:
    """Every variant at B = 2 against its plain version; prints one line
    per variant and the summary last."""
    if torch.device(device).type == "cuda":
        timing.require_cuda(device)  # no card: raise, never run elsewhere
    s, tables = make_inputs(2, device)
    ok = True
    for name in kmb.VARIANTS:
        got = kmb.lookup_variant(name, s, tables[name])
        equal = torch.equal(got, kmb.lookup_variant_ref(name, s, tables[name]))
        ok &= equal
        print(json.dumps({"variant": name, "smoke": True, "equal": equal,
                          "device": str(got.device)}))
    print(json.dumps({"smoke": True, "variants": len(kmb.VARIANTS), "ok": ok}))
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m data_compression_tpu_torch.tools.microbench")
    ap.add_argument("--smoke", action="store_true", help="tiny check, no timing")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --smoke also runs on cpu)")
    args = ap.parse_args(argv)
    if args.smoke:
        return 0 if smoke(args.device) else 1
    dev = timing.require_cuda(args.device)
    print(json.dumps({"card": timing.card(), "device": torch.cuda.get_device_name(dev),
                      "B": B, "C": C, "lanes": LANES,
                      "timing": "median of 30 per-launch CUDA events, input cold in L2"}))
    for r in run(dev):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
