"""Golden wire hashes: the JAX package's frames of seeded inputs at
Huffman arities 2, 16 and 3 and for the serial codecs (literal, nybble,
small_byte with and without the ISPRINT mode, small_nybble), recorded in
tests/data/torch_golden.json,
recomputed here with the JAX package (so the record cannot rot) and with
the port on the CPU.
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
from data_compression_tpu_torch.utils.corpora import GENERATORS, enwik_like

GOLDEN = Path(__file__).parent / "data" / "torch_golden.json"

CASES = [
    # name, generator, size, seed, shared_table, arity, codec, isprint_literal
    ("enwik_1mib", "enwik_like", 1 << 20, 1, False, 2, "huffman", False),
    ("deep_code_block", "deep_code_block", 64 * 1024, 2, False, 2, "huffman", False),
    ("partial_tail_shared", "enwik_like", 200_000, 3, True, 2, "huffman", False),
    ("enwik_1mib_n16", "enwik_like", 1 << 20, 4, False, 16, "huffman", False),
    ("partial_tail_shared_n16", "enwik_like", 200_000, 5, True, 16, "huffman", False),
    ("enwik_1mib_n3", "enwik_like", 1 << 20, 6, False, 3, "huffman", False),
    ("partial_tail_shared_n3", "enwik_like", 200_000, 7, True, 3, "huffman", False),
    ("literal_enwik_1mib", "enwik_like", 1 << 20, 11, False, 2, "literal", False),
    ("literal_partial_tail", "enwik_like", 200_000, 12, False, 2, "literal", False),
    ("nybble_enwik_1mib", "enwik_like", 1 << 20, 13, False, 2, "nybble", False),
    ("nybble_partial_tail", "enwik_like", 200_000, 14, False, 2, "nybble", False),
    ("small_byte_enwik_1mib", "enwik_like", 1 << 20, 15, False, 2, "small_byte", False),
    ("small_byte_partial_tail", "enwik_like", 200_000, 16, False, 2, "small_byte", False),
    # every enwik-like block holds a newline, so this frame is scheme A's;
    # the printable tail's blocks are all 0x1f streams
    ("isprint_enwik_1mib", "enwik_like", 1 << 20, 17, False, 2, "small_byte", True),
    ("isprint_printable_partial_tail", "printable_like", 200_000, 18, False, 2, "small_byte",
     True),
    ("small_nybble_enwik_1mib", "enwik_like", 1 << 20, 19, False, 2, "small_nybble", False),
    ("small_nybble_partial_tail", "enwik_like", 200_000, 20, False, 2, "small_nybble", False),
]
IDS = [c[0] for c in CASES]
FIELDS = ("name", "gen", "size", "seed", "shared_table", "arity", "codec", "isprint_literal")


def _input(gen, size, seed):
    return GENERATORS[gen](size, seed)


def _kw(shared, arity, codec, isprint):
    return dict(codec=codec, arity=arity, shared_table=shared, isprint_literal=isprint)


def _jax_frame(x, shared, arity, codec, isprint):
    return jx.compress(x, jx.CodecConfig(use_device=False, **_kw(shared, arity, codec, isprint)))


def _record():
    cases = []
    for case in CASES:
        name, gen, size, seed, shared, arity, codec, isprint = case
        f = _jax_frame(_input(gen, size, seed), shared, arity, codec, isprint)
        cases.append(dict(zip(FIELDS, case), length=len(f), sha256=hashlib.sha256(f).hexdigest()))
    return {"config": "CodecConfig defaults (64 KiB blocks, 512-symbol chunks) with each "
                      "case's codec, arity, shared_table and isprint_literal",
            "cases": cases}


def _golden():
    return {c["name"]: c for c in json.loads(GOLDEN.read_text())["cases"]}


@pytest.mark.parametrize(",".join(FIELDS), CASES, ids=IDS)
def test_golden_hash_jax(name, gen, size, seed, shared_table, arity, codec, isprint_literal):
    rec = _golden()[name]
    assert tuple(rec[k] for k in FIELDS) == (name, gen, size, seed, shared_table, arity, codec,
                                             isprint_literal)
    f = _jax_frame(_input(gen, size, seed), shared_table, arity, codec, isprint_literal)
    assert len(f) == rec["length"]
    assert hashlib.sha256(f).hexdigest() == rec["sha256"]


@pytest.mark.parametrize(",".join(FIELDS), CASES, ids=IDS)
def test_golden_hash_port_cpu(name, gen, size, seed, shared_table, arity, codec, isprint_literal):
    rec = _golden()[name]
    x = _input(gen, size, seed)
    f = pt.compress(x, pt.CodecConfig(**_kw(shared_table, arity, codec, isprint_literal)),
                    device="cpu")
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
