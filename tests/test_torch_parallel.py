"""The sharded pipeline on ``torch.distributed`` (gloo, CPU) against the
JAX package's ``compress_sharded`` on the conftest's 8-device CPU mesh:
the Pallas route (interpret mode) at 16 KiB / 128 and the XLA route at
8 KiB / 1024, per-block and shared tables, a world of 1 in this process
and a world of 2 in two spawned processes that import only the port
(there also the multihost entry point's frames of empty input against
JAX ``compress_multihost_bytes``).

Tolerance: exact — frames and decoded outputs are compared as bytes.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

import data_compression_tpu as jx
from data_compression_tpu.models import huffman as jhuff
from data_compression_tpu.parallel import mesh as jmesh
from data_compression_tpu.parallel import multihost as jmultihost
from data_compression_tpu.parallel import pipeline as jpipe

import data_compression_tpu_torch as pt
from data_compression_tpu_torch import framing
from data_compression_tpu_torch.models import huffman as phuff
from data_compression_tpu_torch.parallel import (
    compress_sharded,
    decompress_sharded,
    make_mesh,
    multihost,
)
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (config kwargs, JAX use_pallas); 7 blocks at 8 KiB, 4 at 16 KiB
CONFIGS = {
    "pallas-16k-128": (dict(block_size=16384, chunk_syms=128), True),
    "xla-8k-1024": (dict(block_size=8192, chunk_syms=1024), False),
    "pallas-16k-128-shared": (dict(block_size=16384, chunk_syms=128, shared_table=True), True),
    "xla-8k-1024-shared": (dict(block_size=8192, chunk_syms=1024, shared_table=True), False),
}


def _data():
    return enwik_like(2 * 16384 + 5000, 71) + deep_code_block(16384, 72)


def _sha(b):
    return hashlib.sha256(b).hexdigest()


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX package's sharded frame of ``_data()`` for each config."""
    mesh = jmesh.make_mesh(shape=(8, 1))
    return {
        name: jpipe.compress_sharded(_data(), jx.CodecConfig(**kw), mesh, use_pallas=up)
        for name, (kw, up) in CONFIGS.items()
    }


@pytest.fixture
def gloo1(tmp_path):
    """A gloo world of one rank, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield make_mesh("cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world1_frames_equal_jax_sharded_and_api(gloo1, jax_frames, name):
    kw, _ = CONFIGS[name]
    x = _data()
    frame = compress_sharded(x, pt.CodecConfig(**kw), gloo1)
    assert frame == jax_frames[name]
    assert frame == pt.compress(x, pt.CodecConfig(**kw), device="cpu")
    assert frame == jx.compress(x, jx.CodecConfig(use_device=False, **kw))
    assert decompress_sharded(frame, None, gloo1) == x


def test_world1_ragged_tail(gloo1):
    """Neither a multiple of the block size nor of the JAX device count."""
    x = enwik_like(37 * 1024 + 123, 73)
    cfg = dict(block_size=4096, chunk_syms=512)
    frame = compress_sharded(x, pt.CodecConfig(**cfg), gloo1)
    assert frame == jpipe.compress_sharded(x, jx.CodecConfig(**cfg), jmesh.make_mesh(shape=(8, 1)))
    assert decompress_sharded(frame, None, gloo1) == x


@pytest.mark.parametrize("name", ["pallas-16k-128", "xla-8k-1024-shared"])
def test_world1_cross_decode(gloo1, jax_frames, name):
    """The port decodes the JAX package's sharded frames, and the JAX
    package's sharded decoder (Pallas route where the geometry takes it)
    decodes the port's."""
    kw, up = CONFIGS[name]
    x = _data()
    assert decompress_sharded(jax_frames[name], None, gloo1) == x
    frame = compress_sharded(x, pt.CodecConfig(**kw), gloo1)
    mesh = jmesh.make_mesh(shape=(8, 1))
    assert jpipe.decompress_sharded(frame, None, mesh, use_pallas=up) == x


def test_world1_empty_input(gloo1):
    frame = compress_sharded(b"", pt.CodecConfig(), gloo1)
    assert frame == jpipe.compress_sharded(b"", jx.CodecConfig(), jmesh.make_mesh(shape=(8, 1)))
    assert decompress_sharded(frame, None, gloo1) == b""


@pytest.mark.parametrize("shared", [False, True])
def test_world1_flipped_payload_byte_raises(gloo1, shared):
    x = enwik_like(2 * 4096 + 777, 74)
    stream = compress_sharded(x, pt.CodecConfig(block_size=4096, chunk_syms=512,
                                                shared_table=shared), gloo1)
    f = framing.unpack_frame(stream)
    lo = len(stream) - sum(e.comp_len for e in f.entries)
    rng = np.random.default_rng(75 + shared)
    for pos in sorted(set(int(p) for p in rng.integers(lo, len(stream), 8))) + [lo, len(stream) - 1]:
        corrupt = bytearray(stream)
        corrupt[pos] ^= 0xFF
        with pytest.raises(ValueError):
            decompress_sharded(bytes(corrupt), None, gloo1)


@pytest.mark.parametrize("shared", [False, True])
def test_world1_truncated_table_or_unknown_codec_raises(gloo1, shared):
    """Every cut up to the end of the block table, and codec id 99 under a
    recomputed header CRC, raise ValueError from ``decompress_sharded``."""
    stream = compress_sharded(enwik_like(2 * 4096 + 777, 76),
                              pt.CodecConfig(block_size=4096, chunk_syms=512,
                                             shared_table=shared), gloo1)
    end = len(stream) - sum(e.comp_len for e in framing.unpack_frame(stream).entries)
    for cut in range(end + 1):
        with pytest.raises(ValueError):
            decompress_sharded(stream[:cut], None, gloo1)
    head = bytearray(stream[:28])
    head[8] = 99
    bad = bytes(head) + framing.crc32(bytes(head)).to_bytes(4, "little") + stream[32:]
    with pytest.raises(ValueError, match="codec id 99"):
        decompress_sharded(bad, None, gloo1)


def test_world1_multihost_file_drivers(gloo1, tmp_path):
    x = _data()
    src, dst, back = tmp_path / "in", tmp_path / "out.dctz", tmp_path / "back"
    src.write_bytes(x)
    cfg = pt.CodecConfig(block_size=16384, chunk_syms=128)
    info = multihost.compress_multihost(str(src), str(dst), cfg, device="cpu")
    assert info == {"raw_bytes": len(x), "compressed_bytes": dst.stat().st_size, "hosts": 1}
    assert dst.read_bytes() == pt.compress(x, cfg, device="cpu")
    info = multihost.decompress_multihost(str(dst), str(back), None, device="cpu")
    assert back.read_bytes() == x and info["raw_bytes"] == len(x)
    assert multihost.process_local_block_ids(3).tolist() == [0, 1, 2]


def test_mesh_checks(gloo1):
    assert (gloo1.rank, gloo1.world_size, gloo1.shape, gloo1.axis_names) == (0, 1, (1, 1), ("data", "chunk"))
    with pytest.raises(ValueError, match="nccl"):
        make_mesh("cuda")  # a gloo group does not serve a CUDA device
    with pytest.raises(ValueError, match="shape"):
        make_mesh("cpu", shape=(2, 1))
    with pytest.raises(ValueError, match="huffman"):
        compress_sharded(b"abc", pt.CodecConfig(codec="nybble", chunk_syms=4096), gloo1)


def test_no_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh("cpu")
    with pytest.raises(RuntimeError, match="process group"):
        compress_sharded(b"abc", pt.CodecConfig())  # default mesh
    with pytest.raises(ValueError, match="NCCL"):
        multihost.initialize("nccl", "file:///nonexistent", 1, 0)


@pytest.mark.parametrize("table", [None, bytes(range(256))])
def test_pack_unpack_payload_match_jax(table):
    chunks = [b"", b"\x01\x02", bytes(300)]
    payload = phuff._pack_payload(table, chunks)
    assert payload == jhuff._pack_payload(table, chunks)
    assert phuff._unpack_payload(payload) == jhuff._unpack_payload(payload) == (table, chunks)
    for cut in range(len(payload) - 1):  # every truncation raises ValueError
        with pytest.raises(ValueError):
            phuff._unpack_payload(payload[:cut] if cut else b"")
    with pytest.raises(ValueError):
        phuff._unpack_payload(b"\x02" + payload[1:])  # bad table mode


def test_assemble_payloads_equal_pack_payload():
    """The vectorized assembly equals ``_pack_payload`` per block."""
    cfg = pt.CodecConfig(block_size=64, chunk_syms=16)
    codec = phuff.HuffmanCodec(cfg, "cpu")
    rng = np.random.default_rng(76)
    nb = rng.integers(0, 30, (3, 4))
    raw_lens = np.array([64, 20, 1])
    nb[1, 2:] = 0
    nb[2, 1:] = 0
    flat = rng.integers(0, 256, int(nb.sum()), dtype=np.uint8)
    rows = rng.integers(0, 16, (3, 256)).astype(np.uint8)
    for table_rows in (rows, None):
        got = codec._assemble_payloads(flat, nb, raw_lens, table_rows)
        off = 0
        for i in range(3):
            nr = max(1, -(-int(raw_lens[i]) // 16))
            chunks = []
            for c in range(4):
                chunks.append(flat[off : off + nb[i, c]].tobytes())
                off += nb[i, c]
            tb = None if table_rows is None else rows[i].tobytes()
            assert got[i] == phuff._pack_payload(tb, chunks[:nr])


# ------------------------------------------------------------------
# Two ranks, two processes
# ------------------------------------------------------------------

_WORKER = r"""
import hashlib, json, sys
store, rank, configs = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
from data_compression_tpu_torch import CodecConfig
from data_compression_tpu_torch.parallel import (
    compress_sharded, decompress_sharded, make_mesh, multihost)
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like

multihost.initialize("gloo", f"file://{store}", world_size=2, rank=rank)
data = enwik_like(2 * 16384 + 5000, 71) + deep_code_block(16384, 72)
res = {"frames": {}, "roundtrip": {}}
for name, kw in configs.items():
    cfg = CodecConfig(**kw)
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh("cpu", shape)
        frame = compress_sharded(data, cfg, mesh)
        res["frames"][f"{name} {shape}"] = hashlib.sha256(frame).hexdigest()
        res["roundtrip"][f"{name} {shape}"] = decompress_sharded(frame, None, mesh) == data
    frame = multihost.compress_multihost_bytes(data, cfg, device="cpu")
    res["frames"][f"{name} multihost"] = hashlib.sha256(frame).hexdigest()
    res["roundtrip"][f"{name} multihost"] = (
        multihost.decompress_multihost_bytes(frame, None, device="cpu") == data)
res["empty"] = {}
for n in (2, 3, 16, 5):
    for shared in (False, True):
        try:
            frame = multihost.compress_multihost_bytes(
                b"", CodecConfig(arity=n, shared_table=shared), device="cpu")
            res["empty"][f"{n} {shared}"] = hashlib.sha256(frame).hexdigest()
        except KeyError:
            res["empty"][f"{n} {shared}"] = "KeyError"
res["block_ids"] = multihost.process_local_block_ids(5).tolist()
res["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
import torch.distributed as dist
dist.destroy_process_group()
print("RESULT " + json.dumps(res), flush=True)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the worker as ranks 0 and 1 of a gloo world; -> their results."""
    store = tmp_path_factory.mktemp("gloo2") / "store"
    configs = json.dumps({name: kw for name, (kw, _) in CONFIGS.items()})
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = ROOT
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, str(store), str(r), configs],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=env, cwd=ROOT)
        for r in range(2)
    ]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
            results.append(json.loads(line[len("RESULT "):]))
    except subprocess.TimeoutExpired:
        pytest.fail("a rank of the two-process world timed out")
    finally:
        for p in procs:
            p.kill()
    return results


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_ranks_frames_equal_jax_sharded(two_ranks, jax_frames, name):
    """Both ranks, mesh shapes (2, 1) and (1, 2) and the multihost entry
    point all give the JAX package's frame."""
    want = _sha(jax_frames[name])
    for res in two_ranks:
        got = {k: v for k, v in res["frames"].items() if k.startswith(name + " ")}
        assert len(got) == 3 and set(got.values()) == {want}, got


def test_two_ranks_empty_input_frames_equal_jax_multihost(two_ranks):
    """Empty input through the multihost entry point at world 2: JAX
    ``compress_multihost_bytes``'s frame (the chunk size in the header, a
    shared table of an all-zero histogram), KeyError at n = 5."""
    want = {}
    for n in (2, 3, 16, 5):
        for shared in (False, True):
            try:
                want[f"{n} {shared}"] = _sha(jmultihost.compress_multihost_bytes(
                    b"", jx.CodecConfig(arity=n, shared_table=shared)))
            except KeyError:
                want[f"{n} {shared}"] = "KeyError"
    assert [want[f"5 {s}"] for s in (False, True)] == ["KeyError"] * 2
    for res in two_ranks:
        assert res["empty"] == want


def test_two_ranks_round_trip(two_ranks):
    for res in two_ranks:
        assert res["roundtrip"] and all(res["roundtrip"].values()), res["roundtrip"]


def test_two_ranks_block_ids_and_no_jax(two_ranks):
    assert [r["block_ids"] for r in two_ranks] == [[0, 2, 4], [1, 3]]
    assert [r["jax_imported"] for r in two_ranks] == [[], []]


def test_parallel_package_imports_no_jax():
    code = ("import sys, data_compression_tpu_torch.parallel.multihost; "
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
