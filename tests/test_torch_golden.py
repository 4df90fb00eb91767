"""Golden wire hashes: the JAX package's frames of three seeded inputs,
recorded in tests/data/torch_golden.json, recomputed here with the JAX
package (so the record cannot rot) and with the port on the CPU.
``chip_smoke.py`` checks the same hashes with the port on the GPU.
Tolerance: exact (SHA-256 and length of the frame bytes).

Regenerate the record with ``python -m tests.test_torch_golden``.
"""

import hashlib
import json
from pathlib import Path

import pytest

import data_compression_tpu as jx
import data_compression_tpu_torch as pt
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like

GOLDEN = Path(__file__).parent / "data" / "torch_golden.json"

CASES = [
    # name, generator, size, seed, shared_table
    ("enwik_1mib", "enwik_like", 1 << 20, 1, False),
    ("deep_code_block", "deep_code_block", 64 * 1024, 2, False),
    ("partial_tail_shared", "enwik_like", 200_000, 3, True),
]


def _input(gen, size, seed):
    return (enwik_like if gen == "enwik_like" else deep_code_block)(size, seed)


def _jax_frame(x, shared):
    return jx.compress(x, jx.CodecConfig(shared_table=shared, use_device=False))


def _record():
    cases = []
    for name, gen, size, seed, shared in CASES:
        f = _jax_frame(_input(gen, size, seed), shared)
        cases.append(dict(name=name, gen=gen, size=size, seed=seed,
                          shared_table=shared, length=len(f),
                          sha256=hashlib.sha256(f).hexdigest()))
    return {"config": "CodecConfig defaults (huffman, n=2, 64 KiB blocks, 512-symbol chunks)",
            "cases": cases}


def _golden():
    return {c["name"]: c for c in json.loads(GOLDEN.read_text())["cases"]}


@pytest.mark.parametrize("name,gen,size,seed,shared", CASES, ids=[c[0] for c in CASES])
def test_golden_hash_jax(name, gen, size, seed, shared):
    rec = _golden()[name]
    assert (rec["gen"], rec["size"], rec["seed"], rec["shared_table"]) == (gen, size, seed, shared)
    f = _jax_frame(_input(gen, size, seed), shared)
    assert len(f) == rec["length"]
    assert hashlib.sha256(f).hexdigest() == rec["sha256"]


@pytest.mark.parametrize("name,gen,size,seed,shared", CASES, ids=[c[0] for c in CASES])
def test_golden_hash_port_cpu(name, gen, size, seed, shared):
    rec = _golden()[name]
    x = _input(gen, size, seed)
    f = pt.compress(x, pt.CodecConfig(shared_table=shared), device="cpu")
    assert len(f) == rec["length"]
    assert hashlib.sha256(f).hexdigest() == rec["sha256"]
    assert pt.decompress(f, device="cpu") == x


def test_golden_inputs_are_fixed():
    # the generators use integer arithmetic on PCG64 raw draws only
    assert hashlib.sha256(enwik_like(4096, 1)).hexdigest()[:16] == _golden()[
        "enwik_1mib"]["input_sha256_4k"]


if __name__ == "__main__":
    rec = _record()
    rec["cases"][0]["input_sha256_4k"] = hashlib.sha256(enwik_like(4096, 1)).hexdigest()[:16]
    GOLDEN.write_text(json.dumps(rec, indent=1) + "\n")
    print(GOLDEN.read_text())
