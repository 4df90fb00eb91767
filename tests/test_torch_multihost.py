"""The port's multihost entry points, scaling harness, dry run and
benchmark corpora against the JAX package's, on the CPU.

- ``compress_multihost_bytes`` in a gloo world of one rank against JAX
  ``compress_multihost_bytes`` on the conftest's 8-device CPU mesh (JAX
  ``process_count()`` is 1 without ``jax.distributed``): empty input,
  one byte and ``test_torch_parallel._data()``, at n = 2, 3 and 16 with
  per-block and shared tables, and KeyError at n = 5 on empty input;
- ``measure_encode_throughput`` at world 1 in this process and at world
  2 in two spawned gloo ranks: JAX's keys, and the gathered per-chunk
  wire bytes equal to JAX ``encode_chunks_fast``'s ``nb`` on the same
  blocks and table;
- ``dryrun_multichip`` at 2 and 4 gloo ranks: JAX ``compress_sharded``'s
  frames for the JAX dry run's data and configs, no rank importing jax;
- ``tools.scaling_bench`` at 2 gloo ranks: the report's keys, written to
  ``--out`` only (the repo's ``SCALING.json`` unchanged);
- the corpora copies and ``expected_payload_digits``.

Tolerance: exact — frames, counts and corpora are compared as bytes or
integers.  Each spawned process has a timeout of 180 s.
"""

import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import data_compression_tpu as jx
from data_compression_tpu import framing as jframing
from data_compression_tpu.huffman import canonical as jcanon
from data_compression_tpu.huffman.canonical import lengths_to_codes
from data_compression_tpu.models.huffman import capped_lengths as jcapped
from data_compression_tpu.ops.encode_fast import encode_chunks_fast, pack_encode_table
from data_compression_tpu.parallel import mesh as jmesh
from data_compression_tpu.parallel import multihost as jmh
from data_compression_tpu.parallel import pipeline as jpipe
from data_compression_tpu.utils import corpora as jcorp

import data_compression_tpu_torch as pt
from data_compression_tpu_torch import framing, huffman as phuffman
from data_compression_tpu_torch.parallel import compress_sharded, dryrun, make_mesh, multihost
from data_compression_tpu_torch.tools import scaling_bench
from data_compression_tpu_torch.utils import corpora as pcorp
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = dict(block_size=16384, chunk_syms=128)  # 4 blocks of _data(); JAX pads to 8
INPUTS = {
    "empty": b"",
    "one_byte": b"a",
    "data": enwik_like(2 * 16384 + 5000, 71) + deep_code_block(16384, 72),  # test_torch_parallel._data()
}
THROUGHPUT_BYTES = (1 << 20) + 1000  # 17 blocks of 64 KiB: one pad block at world 2
JAX_KEYS = {"bytes", "best_s", "bytes_per_s", "compute_s", "collective_s", "processes", "devices"}
REPORT_KEYS = {"metric", "value", "unit", "processes", "devices_per_process", "corpus_mb",
               "single_proc", "multi_proc", "cores", "note", "device"}


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = ROOT
    return env


@pytest.fixture
def gloo1(tmp_path):
    """A gloo world of one rank, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield make_mesh("cpu")
    dist.destroy_process_group()


# ------------------------------------------------------------------
# compress_multihost_bytes against JAX compress_multihost_bytes
# ------------------------------------------------------------------


@pytest.mark.parametrize("shared", [False, True], ids=["per_block", "shared"])
@pytest.mark.parametrize("n", [2, 3, 16])
@pytest.mark.parametrize("name", list(INPUTS))
def test_multihost_frame_equals_jax_multihost(gloo1, name, n, shared):
    x = INPUTS[name]
    want = jmh.compress_multihost_bytes(x, jx.CodecConfig(arity=n, shared_table=shared, **GEOMETRY))
    cfg = pt.CodecConfig(arity=n, shared_table=shared, **GEOMETRY)
    frame = multihost.compress_multihost_bytes(x, cfg, device="cpu")
    assert frame == want
    assert multihost.decompress_multihost_bytes(frame, None, device="cpu") == x
    if x:  # the sharded frame, which differs from the multihost one only on empty input
        assert frame == compress_sharded(x, cfg, gloo1)


def test_multihost_empty_frame_records_chunk_size_and_zero_table(gloo1):
    """Per-block: ``api.compress``'s empty frame (chunk size in the header);
    shared: the flag and the 256-byte table of an all-zero histogram."""
    cfg = pt.CodecConfig()
    assert multihost.compress_multihost_bytes(b"", cfg, device="cpu") == pt.compress(b"", cfg,
                                                                                      device="cpu")
    f = framing.unpack_frame(multihost.compress_multihost_bytes(
        b"", pt.CodecConfig(shared_table=True), device="cpu"))
    assert (f.chunk_syms, f.shared_table, f.entries) == (512, bytes(256), [])


@pytest.mark.parametrize("shared", [False, True], ids=["per_block", "shared"])
def test_multihost_empty_input_unpacked_arity_raises_key_error(gloo1, shared):
    with pytest.raises(KeyError):
        jmh.compress_multihost_bytes(b"", jx.CodecConfig(arity=5, shared_table=shared))
    with pytest.raises(KeyError):
        multihost.compress_multihost_bytes(b"", pt.CodecConfig(arity=5, shared_table=shared),
                                           device="cpu")


def test_multihost_empty_input_other_codec_raises_value_error(gloo1):
    with pytest.raises(ValueError, match="huffman"):
        multihost.compress_multihost_bytes(b"", pt.CodecConfig(codec="nybble", chunk_syms=4096),
                                           device="cpu")


# ------------------------------------------------------------------
# measure_encode_throughput
# ------------------------------------------------------------------


def _jax_nb(nbytes: int, world: int) -> list:
    """JAX ``encode_chunks_fast``'s per-chunk wire bytes over the blocks
    and the one table that ``measure_encode_throughput`` builds for a
    world of ``world`` ranks (one small jit)."""
    cfg = jx.CodecConfig()
    S, C, n = cfg.block_size, cfg.chunk_syms, cfg.arity
    ncb = S // C
    blocks, lengths = jframing.split_blocks(jcorp.synthetic_enwik(nbytes, seed=7), S)
    B = -(-blocks.shape[0] // world) * world
    pb = np.zeros((B, S), np.uint8)
    pb[: blocks.shape[0]] = blocks
    pl_ = np.zeros(B, np.int32)
    pl_[: blocks.shape[0]] = lengths
    hist = np.bincount(pb.reshape(-1), minlength=256).astype(np.int64)
    ptab, btab = pack_encode_table(lengths_to_codes(jcapped(hist, n), n))
    counts = np.clip(pl_[:, None] - np.arange(ncb)[None, :] * C, 0, C).reshape(-1)
    tbl = np.repeat(np.zeros(B, np.int32), ncb)
    _, nb, _ = jax.jit(lambda *a: encode_chunks_fast(*a, arity=n, chunk_syms=C))(
        jnp.asarray(pb.reshape(B * ncb, C)), jnp.asarray(counts, jnp.int32),
        jnp.asarray(ptab[None]), jnp.asarray(btab[None]), jnp.asarray(tbl))
    return np.asarray(nb).tolist()


def test_measure_encode_throughput_world1(gloo1):
    r = multihost.measure_encode_throughput(pt.CodecConfig(), THROUGHPUT_BYTES, iters=2,
                                            device="cpu")
    assert set(r) == JAX_KEYS
    assert (r["bytes"], r["processes"], r["devices"]) == (THROUGHPUT_BYTES, 1, 1)
    assert r["bytes_per_s"] > 0 and r["collective_s"] >= 0
    assert r["bytes_per_s"] == pytest.approx(THROUGHPUT_BYTES / r["best_s"])
    cfg = pt.CodecConfig()
    share = multihost.encode_share(cfg, THROUGHPUT_BYTES, gloo1)
    counts = multihost.encode_counts(*share, cfg, gloo1)
    assert counts.tolist() == _jax_nb(THROUGHPUT_BYTES, 1)
    assert counts.tolist() == multihost.encode_counts(*share, cfg).tolist()


_THROUGHPUT_WORKER = r"""
import json, sys
store, rank, nbytes = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
import torch.distributed as dist
from data_compression_tpu_torch import CodecConfig
from data_compression_tpu_torch.parallel import make_mesh, multihost

multihost.initialize("gloo", f"file://{store}", world_size=2, rank=rank)
cfg = CodecConfig()
r = multihost.measure_encode_throughput(cfg, nbytes, iters=2, device="cpu")
mesh = make_mesh("cpu")
counts = multihost.encode_counts(*multihost.encode_share(cfg, nbytes, mesh), cfg, mesh)
r["counts"] = counts.tolist()
r["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
dist.destroy_process_group()
print("RESULT " + json.dumps(r), flush=True)
"""


@pytest.fixture(scope="module")
def throughput_two_ranks(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo2") / "store"
    procs = [
        subprocess.Popen([sys.executable, "-c", _THROUGHPUT_WORKER, str(store), str(r),
                          str(THROUGHPUT_BYTES)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=_clean_env(), cwd=ROOT)
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


def test_measure_encode_throughput_world2(throughput_two_ranks):
    want = _jax_nb(THROUGHPUT_BYTES, 2)
    for r in throughput_two_ranks:
        assert set(r) == JAX_KEYS | {"counts", "jax_imported"}
        assert (r["bytes"], r["processes"], r["devices"]) == (THROUGHPUT_BYTES, 2, 2)
        assert r["bytes_per_s"] > 0 and r["collective_s"] >= 0
        assert r["counts"] == want
        assert r["jax_imported"] == []


# ------------------------------------------------------------------
# the dry run and the scaling tool
# ------------------------------------------------------------------


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dryrun_multichip_frames_equal_jax_sharded(n_ranks, capsys):
    report = dryrun.dryrun_multichip(n_ranks, "cpu", timeout=180)
    assert report["jax_modules"] == []
    assert report["mesh"] == dict(zip(("data", "chunk"), dryrun.mesh_shape(n_ranks)))
    mesh = jmesh.make_mesh(shape=(8, 1))
    for name, x in dryrun.dryrun_data(n_ranks).items():
        want = jpipe.compress_sharded(x, jx.CodecConfig(**dryrun.ROUND_TRIPS[name]), mesh)
        got = report["frames"][name]
        assert (got["raw"], got["bytes"], got["sha256"]) == (
            len(x), len(want), hashlib.sha256(want).hexdigest()), name
    assert "dryrun_multichip OK: mesh" in capsys.readouterr().out


def test_dryrun_data_and_mesh_are_the_jax_dry_runs():
    """Data from ``default_rng(42)`` over the JAX dry run's letters; its mesh shapes."""
    rng = np.random.default_rng(42)
    letters = np.frombuffer(b" eetaoinshrdlcumwfgypbvk.,\n", np.uint8)
    data = rng.choice(letters, size=3 * 4 * 2048).tobytes()
    data3 = rng.choice(letters, size=3 * 16384).tobytes()
    assert dryrun.dryrun_data(3) == {"per_block": data, "shared": data, "16k_128": data3}
    assert [dryrun.mesh_shape(n) for n in (1, 2, 3, 4, 8)] == [(1, 1), (2, 1), (3, 1), (2, 2), (4, 2)]


def test_scaling_bench_cpu_writes_out_only(tmp_path):
    scaling = os.path.join(ROOT, "SCALING.json")
    before = hashlib.sha256(open(scaling, "rb").read()).hexdigest()
    out = tmp_path / "scaling.json"
    r = subprocess.run([sys.executable, "-m", "data_compression_tpu_torch.tools.scaling_bench",
                        "2", "1", "--device", "cpu", "--out", str(out)],
                       capture_output=True, text=True, env=_clean_env(), cwd=ROOT, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == report
    assert set(report) == REPORT_KEYS
    assert (report["processes"], report["devices_per_process"], report["corpus_mb"],
            report["device"]) == (2, 1, 1, "cpu")
    for key, world in (("single_proc", 1), ("multi_proc", 2)):
        assert set(report[key]) == JAX_KEYS
        assert (report[key]["processes"], report[key]["devices"]) == (world, world)
        assert report[key]["bytes_per_s"] > 0 and report[key]["collective_s"] >= 0
    assert report["value"] == round(report["multi_proc"]["bytes_per_s"] / 2
                                    / report["single_proc"]["bytes_per_s"], 4)
    assert hashlib.sha256(open(scaling, "rb").read()).hexdigest() == before


@pytest.mark.parametrize("call", ["dryrun", "scaling_bench", "scaling_bench_cli"])
def test_more_ranks_than_cards_raises_value_error(call):
    """Never a fall back to the CPU: ranks on cuda need a card each (this
    machine may have none)."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"{n} NCCL ranks need {n} CUDA devices"):
        if call == "dryrun":
            dryrun.dryrun_multichip(n, "cuda")
        elif call == "scaling_bench":
            scaling_bench.run(n, 1, "cuda")
        else:
            scaling_bench.main([str(n), "1", "--device", "cuda"])


def test_new_modules_import_no_jax():
    code = ("import sys, data_compression_tpu_torch.parallel.dryrun, "
            "data_compression_tpu_torch.tools.scaling_bench, "
            "data_compression_tpu_torch.utils.corpora, data_compression_tpu_torch.parallel.launch; "
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=_clean_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------------
# corpora and expected_payload_digits
# ------------------------------------------------------------------


@pytest.mark.parametrize("nbytes,seed", [(0, 0), (1, 3), (1000, 7), (65537, 11), (300001, 2)])
@pytest.mark.parametrize("fn", ["synthetic_enwik", "synthetic_english", "mixed_corpus"])
def test_corpora_equal_jax(fn, nbytes, seed):
    assert getattr(pcorp, fn)(nbytes, seed) == getattr(jcorp, fn)(nbytes, seed)


@pytest.mark.parametrize("name,nbytes", [("enwik6", 5000), ("enwik8", 12345),
                                         ("alice29.txt", 7000), ("other", 3000)])
def test_load_or_synthesize_equal_jax(name, nbytes):
    assert pcorp.load_or_synthesize(name, nbytes, 5) == jcorp.load_or_synthesize(name, nbytes, 5)


def test_repo_source_corpus_equal_jax(tmp_path, monkeypatch):
    """Both walk ``<root>/<package>``, ``<root>/tests`` and ``<root>/tools``
    from their own file: one temporary tree for both."""
    files = {
        "pkg/utils/corpora.py": b"# corpora\n",
        "pkg/a.py": b"print(1)\n",
        "pkg/sub/b.c": b"int b;\n",
        "pkg/sub/skip.cu": b"__global__ void k();\n",
        "pkg/README.md": b"# pkg\n",
        "tests/test_x.py": b"def test(): pass\n",
        "tools/z/t.md": b"tool\n",
        "tools/y.py": b"y = 2\n",
        "other/ignored.py": b"no\n",
    }
    for rel, body in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(body)
    fake = str(tmp_path / "pkg" / "utils" / "corpora.py")
    monkeypatch.setattr(pcorp, "__file__", fake)
    monkeypatch.setattr(jcorp, "__file__", fake)
    whole = pcorp.repo_source_corpus()
    assert whole == jcorp.repo_source_corpus()
    assert b"skip" not in whole and b"no\n" not in whole and b"tool\n" in whole
    for nbytes in (1, 50, 1000):
        assert pcorp.repo_source_corpus(nbytes) == jcorp.repo_source_corpus(nbytes)
        assert len(pcorp.repo_source_corpus(nbytes)) == nbytes


def test_repo_source_corpus_reads_the_port():
    data = pcorp.repo_source_corpus()
    assert b"def repo_source_corpus" in data and b"def measure_encode_throughput" in data
    assert pcorp.repo_source_corpus(len(data) * 2 + 1) == (data * 3)[: len(data) * 2 + 1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expected_payload_digits_equal_jax(seed):
    rng = np.random.default_rng(seed)
    freqs = rng.integers(0, 1 << 40, 256)
    lengths = rng.integers(0, 16, 256).astype(np.int32)
    got = phuffman.expected_payload_digits(freqs, lengths)
    assert got == jcanon.expected_payload_digits(freqs, lengths)
    assert isinstance(got, int)
