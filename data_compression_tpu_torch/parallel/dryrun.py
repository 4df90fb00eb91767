"""n-rank sharded round trip, the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``.

    python -m data_compression_tpu_torch.parallel.dryrun N [--device cuda|cpu]

spawns N processes, one rank each: gloo on the CPU, or NCCL with rank r
on ``cuda:r`` (a machine with fewer cards than ranks raises ValueError;
nothing falls back to the CPU).  The ranks form the JAX dry run's mesh,
``(N/2, 2)`` for an even N above 2 and ``(N, 1)`` otherwise, and run its
three round trips on its data (``default_rng(42)`` over its letters):
per-block tables at n=2 and shared tables at n=3, both with 2 KiB blocks
of 512-symbol chunks, then n=2 with 16 KiB blocks of 128-symbol chunks
(which the JAX dry run sends through its Pallas route; the port has one
route).  Each round trip must be exact; every rank must hold the same
frames; rank 0 prints ``dryrun_multichip OK: ...`` with the frame sizes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np

from data_compression_tpu_torch.parallel.launch import (
    BACKENDS, init_method, require_cards, run_ranks,
)

LETTERS = b" eetaoinshrdlcumwfgypbvk.,\n"
# the JAX dry run's round trips: name -> config keywords
ROUND_TRIPS = {
    "per_block": dict(arity=2, block_size=2048, chunk_syms=512),
    "shared": dict(arity=3, block_size=2048, chunk_syms=512, shared_table=True),
    "16k_128": dict(arity=2, block_size=16384, chunk_syms=128),
}
_REPORT = "DRYRUN "


def mesh_shape(n_ranks: int) -> tuple:
    """The JAX dry run's mesh: ("data", "chunk") = (n/2, 2) for an even n
    above 2, else (n, 1)."""
    return (n_ranks // 2, 2) if n_ranks % 2 == 0 and n_ranks > 2 else (n_ranks, 1)


def dryrun_data(n_ranks: int) -> dict:
    """The JAX dry run's inputs by round trip: 4 x 2 KiB a rank of seeded
    letters, then 16 KiB a rank from the same generator."""
    rng = np.random.default_rng(42)
    letters = np.frombuffer(LETTERS, np.uint8)
    data = rng.choice(letters, size=n_ranks * 4 * 2048).tobytes()
    data3 = rng.choice(letters, size=n_ranks * 16384).tobytes()
    return {"per_block": data, "shared": data, "16k_128": data3}


def run_rank(rank: int, n_ranks: int, init: str, device: str) -> dict:
    """One rank's dry run in a group it creates and destroys; -> its
    report (mesh, each round trip's raw bytes, frame bytes and sha256,
    the jax modules loaded)."""
    import torch
    import torch.distributed as dist

    from data_compression_tpu_torch.config import CodecConfig
    from data_compression_tpu_torch.parallel import multihost
    from data_compression_tpu_torch.parallel.mesh import AXES, make_mesh
    from data_compression_tpu_torch.parallel.pipeline import compress_sharded, decompress_sharded

    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    multihost.initialize(BACKENDS[device], init, n_ranks, rank,
                         device=dev if device == "cuda" else None)
    try:
        mesh = make_mesh(dev, mesh_shape(n_ranks))
        frames = {}
        for name, x in dryrun_data(n_ranks).items():
            kw = ROUND_TRIPS[name]
            out = compress_sharded(x, CodecConfig(**kw), mesh)
            back = decompress_sharded(out, CodecConfig(chunk_syms=kw["chunk_syms"]), mesh)
            if back != x:
                raise AssertionError(f"multichip {name} round trip mismatch")
            frames[name] = {"raw": len(x), "bytes": len(out),
                            "sha256": hashlib.sha256(out).hexdigest()}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        f = frames
        print(f"dryrun_multichip OK: mesh {dict(zip(AXES, mesh.shape))}, {device}, "
              f"{f['per_block']['raw']} bytes -> {f['per_block']['bytes']} (per-block) / "
              f"{f['shared']['bytes']} (shared); 16 KiB/128 {f['16k_128']['raw']} -> "
              f"{f['16k_128']['bytes']}", flush=True)
    return {"rank": rank, "mesh": dict(zip(AXES, mesh.shape)), "frames": frames,
            "jax_modules": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))}


def dryrun_multichip(n_ranks: int, device: str = "cuda", timeout: float = 600) -> dict:
    """Run the dry run in ``n_ranks`` child processes and print rank 0's
    lines.  -> rank 0's report, ``jax_modules`` the union over the ranks.
    Raises if a rank fails or times out, or if the ranks' frames differ."""
    require_cards(n_ranks, device)
    init = init_method()
    outs = run_ranks(lambda r: ["-m", "data_compression_tpu_torch.parallel.dryrun", str(n_ranks),
                                "--device", device, "--rank", str(r), "--init", init],
                     n_ranks, timeout)
    reports = []
    for r, out in enumerate(outs):
        lines = out.splitlines()
        reports.append(json.loads([ln for ln in lines if ln.startswith(_REPORT)][-1][len(_REPORT):]))
        if r == 0:
            print("\n".join(ln for ln in lines if not ln.startswith(_REPORT)), flush=True)
    if any(rep["frames"] != reports[0]["frames"] for rep in reports):
        raise AssertionError("the ranks' frames differ")
    return {**reports[0], "jax_modules": sorted({m for rep in reports for m in rep["jax_modules"]})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--device", choices=sorted(BACKENDS), default="cuda")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)  # a rank of the run
    ap.add_argument("--init", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n_ranks, args.device)
    else:
        report = run_rank(args.rank, args.n_ranks, args.init, args.device)
        print(_REPORT + json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
