"""The profiling tools' slice of the port on the CPU: the copy and
lookup-variant plain versions against the TPU bodies of ``tools/ablate.py``
and ``tools/microbench.py`` (copied here, run by ``pl.pallas_call`` in
interpret mode), the stage observables of the plain rows encode and plain
decode against their definitions at n = 2, 16 and 3, and both tools'
``--smoke`` runs.

Tolerance: exact everywhere (integer outputs).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import data_compression_tpu.huffman.batched as jhb
from data_compression_tpu.models.huffman import encode_chunk_np

from data_compression_tpu_torch import CodecConfig, framing
from data_compression_tpu_torch.config import ARITY_MAX_LEN, wire_bytes
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.models.huffman import HuffmanCodec
from data_compression_tpu_torch.ops.kernels import copy as kcopy
from data_compression_tpu_torch.ops.kernels import decode as kdec
from data_compression_tpu_torch.ops.kernels import encode as kenc
from data_compression_tpu_torch.ops.kernels import microbench as kmb
from data_compression_tpu_torch.tools import ablate, microbench, timing
from data_compression_tpu_torch.utils.corpora import complete_lengths, deep_code_block, enwik_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 128
B = 2  # blocks of the microbenchmark's shapes run in interpret mode
ARITIES = [2, 16, 3]


# ---- the TPU bodies, copied from tools/ablate.py:144-147 and
# tools/microbench.py:75-188 (C is the symbols per lane of the call)

def copy_kernel(x_ref, o_ref):  # tools/ablate.py:144-147
    o_ref[0] = x_ref[0]


def bodies(C):
    def k0(s_ref, o_ref):  # :75-76
        o_ref[0] = s_ref[0]

    def k1(s_ref, o_ref):  # :80-82
        s = s_ref[0].astype(jnp.int32)
        o_ref[0] = (s & 0xFF).astype(jnp.uint8)

    def k2(s_ref, t_ref, o_ref):  # :86-94
        s = s_ref[0].astype(jnp.int32)
        i7 = s & 127
        lo = jnp.take_along_axis(
            jnp.broadcast_to(t_ref[0, 0:1, :], s.shape), i7, axis=1)
        hi = jnp.take_along_axis(
            jnp.broadcast_to(t_ref[0, 1:2, :], s.shape), i7, axis=1)
        w = jnp.where(s < 128, lo, hi)
        o_ref[0] = (w & 0xFF).astype(jnp.uint8)

    def k2b(s_ref, t_ref, o_ref):  # :98-103
        s = s_ref[0].astype(jnp.int32)
        i7 = s & 127
        lo = jnp.take_along_axis(
            jnp.broadcast_to(t_ref[0, 0:1, :], s.shape), i7, axis=1)
        o_ref[0] = (lo & 0xFF).astype(jnp.uint8)

    def k3(s_ref, t_ref, o_ref):  # :107-114
        s = s_ref[0]  # uint8
        i7 = s & jnp.uint8(127)
        lo = jnp.take_along_axis(
            jnp.broadcast_to(t_ref[0, 0:1, :], s.shape), i7, axis=1)
        hi = jnp.take_along_axis(
            jnp.broadcast_to(t_ref[0, 1:2, :], s.shape), i7, axis=1)
        o_ref[0] = jnp.where(s < 128, lo, hi)

    def k3b(s_ref, t_ref, o_ref):  # :118-131
        s = s_ref[0]
        i7 = s & jnp.uint8(127)
        acc = None
        for r in range(3):
            lo = jnp.take_along_axis(
                jnp.broadcast_to(t_ref[0, 2 * r:2 * r + 1, :], s.shape),
                i7, axis=1)
            hi = jnp.take_along_axis(
                jnp.broadcast_to(t_ref[0, 2 * r + 1:2 * r + 2, :], s.shape),
                i7, axis=1)
            v = jnp.where(s < 128, lo, hi)
            acc = v if acc is None else acc ^ v
        o_ref[0] = acc

    def k4(s_ref, t_ref, o_ref):  # :135-143
        s = s_ref[0].astype(jnp.int16)
        i7 = s & jnp.int16(127)
        lo = jnp.take_along_axis(
            jnp.broadcast_to(t_ref[0, 0:1, :], s.shape), i7, axis=1)
        hi = jnp.take_along_axis(
            jnp.broadcast_to(t_ref[0, 1:2, :], s.shape), i7, axis=1)
        w = jnp.where(s < 128, lo, hi)
        o_ref[0] = (w & 0xFF).astype(jnp.uint8)

    def k5(s_ref, t_ref, o_ref):  # :147-155
        s = s_ref[0].astype(jnp.int32)
        i7 = s & 127
        T0 = jnp.broadcast_to(t_ref[0, 0:1, :], (C, LANES))
        T1 = jnp.broadcast_to(t_ref[0, 1:2, :], (C, LANES))
        lo = jnp.take_along_axis(T0, i7, axis=1)
        hi = jnp.take_along_axis(T1, i7, axis=1)
        w = jnp.where(s < 128, lo, hi)
        o_ref[0] = (w & 0xFF).astype(jnp.uint8)

    def k6(s_ref, t_ref, o_ref):  # :159-168
        t0 = jnp.broadcast_to(t_ref[0, 0:1, :], (8, LANES))
        t1 = jnp.broadcast_to(t_ref[0, 1:2, :], (8, LANES))
        for g in range(C // 8):
            s = s_ref[0, g * 8:(g + 1) * 8, :].astype(jnp.int32)
            i7 = s & 127
            lo = jnp.take_along_axis(t0, i7, axis=1)
            hi = jnp.take_along_axis(t1, i7, axis=1)
            w = jnp.where(s < 128, lo, hi)
            o_ref[0, g * 8:(g + 1) * 8, :] = (w & 0xFF).astype(jnp.uint8)

    def k7(s_ref, t_ref, o_ref):  # :172-188
        s = s_ref[0].astype(jnp.int32)
        i7 = s & 127
        lo = jnp.take_along_axis(
            jnp.broadcast_to(t_ref[0, 0:1, :], s.shape), i7, axis=1)
        hi = jnp.take_along_axis(
            jnp.broadcast_to(t_ref[0, 1:2, :], s.shape), i7, axis=1)
        p = jnp.where(s < 128, lo, hi)
        l = jax.lax.shift_right_logical(p, 15)
        w = p & 0x7FFF
        lane = jax.lax.broadcasted_iota(jnp.int32, (C, LANES), 1)
        pos = jax.lax.broadcasted_iota(jnp.int32, (C, LANES), 0)
        cc = jnp.clip(65536 - lane * C, 0, C)
        valid = pos < cc
        w = jnp.where(valid, w, 0)
        l = jnp.where(valid, l, 0)
        o_ref[0] = ((w ^ l) & 0xFF).astype(jnp.uint8)

    return dict(zip(kmb.VARIANTS, (k0, k1, k2, k2b, k3, k3b, k4, k5, k6, k7)))


def run_tpu_body(kernel, s, table=None):
    """``tools/microbench.py:37-51`` ``run_variant.go`` in interpret mode."""
    nb, C, _ = s.shape
    spec = pl.BlockSpec((1, C, LANES), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    extra = () if table is None else (table,)
    extra_specs = [pl.BlockSpec((1, t.shape[1], LANES), lambda i: (i, 0, 0),
                                memory_space=pltpu.VMEM) for t in extra]
    out = pl.pallas_call(
        kernel, grid=(nb,), in_specs=[spec, *extra_specs], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((nb, C, LANES), jnp.uint8), interpret=True,
    )(jnp.asarray(s), *map(jnp.asarray, extra))
    return np.asarray(out)


def test_copy_plain_matches_tpu_body():
    x = np.random.default_rng(3).integers(0, 256, (B, 512, LANES), np.uint8)
    got = kcopy.copy_blocks_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), run_tpu_body(copy_kernel, x))


@pytest.mark.parametrize("name", kmb.VARIANTS)
def test_lookup_plain_matches_tpu_body(name):
    s, tables = microbench.make_inputs(B, "cpu")
    t = tables[name]
    want = run_tpu_body(bodies(microbench.C)[name], s.numpy(), None if t is None else t.numpy())
    np.testing.assert_array_equal(kmb.lookup_variant_ref(name, s, t).numpy(), want)


@pytest.mark.parametrize("name", ["stage1_like", "gather256_i32_vreg_loop"])
def test_lookup_plain_matches_tpu_body_other_width(name):
    """C = 576: stage1_like's lane mask then ends lane 113 at position
    448 and masks every position of lanes >= 114."""
    C = 576
    s = np.random.default_rng(4).integers(0, 256, (B, C, LANES), np.uint8)
    t = np.random.default_rng(5).integers(-2**31, 2**31, (B, 2, LANES), np.int64).astype(np.int32)
    want = run_tpu_body(bodies(C)[name], s, t)
    got = kmb.lookup_variant_ref(name, torch.from_numpy(s), torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "stage1_like":
        assert not want[:, 448:, 113].any() and not want[:, :, 114:].any()
        assert want[:, :448, 113].any()


@pytest.mark.parametrize("name", kmb.VARIANTS)
def test_library_call_computes_the_variant(name):
    """The microbenchmark's library call writes the variant's own uint8
    result; only the x3 and stage1_like variants have none."""
    s, tables = microbench.make_inputs(B, "cpu")
    call = microbench.library_call(name, s, tables[name])
    if name in ("gather256_u8_x3", "stage1_like"):
        assert call is None and name not in microbench.LIBRARY_VARIANTS
        return
    got = call().view(s.shape)
    assert got.dtype == torch.uint8
    assert torch.equal(got, kmb.lookup_variant_ref(name, s, tables[name]))


def test_variants_name_their_tpu_bodies():
    """Each variant's REPLACES points at its ``def k...`` body."""
    with open(os.path.join(ROOT, "tools", "microbench.py")) as f:
        lines = f.read().splitlines()
    bodies_at = [int(kmb.REPLACES[v].rsplit(":", 1)[1]) for v in kmb.VARIANTS]
    assert [lines[i - 1].split("(")[0].strip() for i in bodies_at] == [
        "def k0", "def k1", "def k2", "def k2b", "def k3", "def k3b", "def k4", "def k5",
        "def k6", "def k7"]


@pytest.mark.parametrize("C", [64, 128, 512, 576])
def test_lookup_wrappers_take_any_whole_block_width(C):
    """A block of any multiple of 8 KiB (C a multiple of 64), whether or
    not a 4-word slice divides it: the CPU result is the plain version's;
    C off that grid raises."""
    s = torch.randint(0, 256, (2, C, kmb.LANES), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(C))
    _, tables = microbench.make_inputs(2, "cpu")
    for name in kmb.VARIANTS:
        assert torch.equal(kmb.lookup_variant(name, s, tables[name]),
                           kmb.lookup_variant_ref(name, s, tables[name]))
        with pytest.raises(ValueError, match="multiple of 64"):
            kmb.lookup_variant(name, s[:, : C - 32].contiguous(), tables[name])


def test_cpu_wrappers_are_plain_versions_and_check_inputs():
    s, tables = microbench.make_inputs(B, "cpu")
    before = {n: w.launches for n, w in kmb.WRAPPERS.items()}
    for name in kmb.VARIANTS:
        got = kmb.lookup_variant(name, s, tables[name])
        assert torch.equal(got, kmb.lookup_variant_ref(name, s, tables[name]))
    assert {n: w.launches for n, w in kmb.WRAPPERS.items()} == before
    with pytest.raises(ValueError):
        kmb.lookup_variant("gather512", s, tables["gather256_i32"])
    with pytest.raises(ValueError):
        kmb.lookup_variant("gather256_i32", s, tables["gather256_u8"])  # wrong table type
    with pytest.raises(ValueError):
        kmb.lookup_variant("passthrough", s, tables["gather256_i32"])  # takes no table
    with pytest.raises(ValueError):
        kmb.lookup_variant("passthrough", s[:, :32])  # C not a multiple of 64
    x = s.clone()
    n0 = kcopy.copy_blocks.launches
    y = kcopy.copy_blocks(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert kcopy.copy_blocks.launches == n0
    with pytest.raises(ValueError):
        kcopy.copy_blocks(x.to(torch.int16))


# ---- stage observables of the plain rows encode and decode

def _stage_case(n):
    """Four 4 KiB blocks (the last short) at C = 512 with the tables and
    decode arguments the tools build; block 2 is the deep-code block,
    coded at n = 3 and 16 by a complete tree at the length cap, its
    chunk 0 made of L-digit symbols."""
    S, C, L = 4096, 512, ARITY_MAX_LEN[n]
    cfg = CodecConfig(arity=n, block_size=S, chunk_syms=C)
    codec = HuffmanCodec(cfg, "cpu")
    data = enwik_like(2 * S, 71) + deep_code_block(S, 72) + enwik_like(1000, 73)
    blocks, lengths = framing.split_blocks(data, S)
    dev_blocks, dev_lens = codec.upload_blocks(blocks, lengths)
    tb, _ = codec.tables(dev_blocks, dev_lens)
    if n != 2:
        lens = tb.lengths.copy()
        lens[2] = complete_lengths(n, L, 256 if n == 16 else 255)
        tb = hb.codes_batch(lens, n)
    deep = np.flatnonzero(tb.lengths[2] == L)
    blocks[2, :C] = deep[np.arange(C) % deep.size]
    dev_blocks = torch.from_numpy(blocks)
    dense = hb.encode_tensors(tb, "cpu")["dense"]
    rows, digits = kenc.encode_chunk_rows_ref(dev_blocks, dev_lens, dense, C, n)
    nb = wire_bytes(digits.long(), n)
    flat = rows[torch.arange(rows.shape[1])[None, :] < nb[:, None]].numpy()
    payloads = codec._assemble_payloads(flat, nb.view(4, -1).numpy(), lengths, tb.table_bytes())
    args, _ = codec.decode_inputs(payloads, lengths, None)
    jt = jhb.codes_batch(tb.lengths, n)  # the JAX package's tables
    chunks = [(b, blocks[b, c * C: min(int(lengths[b]), (c + 1) * C)])
              for b in range(4) for c in range(S // C)]
    # the chunks a frame carries: at least one per block
    kept = [(b, syms) for i, (b, syms) in enumerate(chunks) if syms.size or i % (S // C) == 0]
    return dict(blocks=dev_blocks, lens=dev_lens, dense=dense, C=C, rows=rows, digits=digits,
                args=args, jt=jt, chunks=chunks, kept=kept)


@pytest.fixture(scope="module", params=ARITIES)
def stage_case(request):
    return request.param, _stage_case(request.param)


@pytest.mark.parametrize("stage", [1, 2])
def test_encode_stage_observables(stage_case, stage):
    """Stage 1: the chunk's digit count; stage 2: the sum of its wire
    bytes, both from the JAX host encoder; rows at stage 3 unchanged."""
    n, c = stage_case
    _, got = kenc.encode_chunk_rows(c["blocks"], c["lens"], c["dense"], c["C"], n, stages=stage)
    want = []
    for b, syms in c["chunks"]:
        if stage == 1:
            want.append(int(c["jt"].lengths[b][syms].sum()))
        else:
            want.append(sum(encode_chunk_np(syms, c["jt"].table(b))) if syms.size else 0)
    assert got.tolist() == want
    assert max(want) > 0
    rows, digits = kenc.encode_chunk_rows(c["blocks"], c["lens"], c["dense"], c["C"], n)
    assert torch.equal(rows, c["rows"]) and torch.equal(digits, c["digits"])
    if stage == 1:
        assert int(digits.max()) == ARITY_MAX_LEN[n] * c["C"]  # a full row is covered


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_decode_stage_observables(stage_case, stage):
    """Sums over each chunk of its symbols' code lengths (stage 1), ranks
    in the block's canonical symbol order (2) and bytes (3), from the
    input and the JAX package's tables; stage 4 gives back the input."""
    n, c = stage_case
    jt = c["jt"]
    want = []
    for b, syms in c["kept"]:
        rank_of = {int(s): r for r, s in enumerate(jt.sorted_symbols[b][: jt.n_used[b]])}
        per = {1: jt.lengths[b][syms], 2: [rank_of[int(s)] for s in syms], 3: syms}[stage]
        want.append(int(np.sum(per, dtype=np.int64)))
    assert len(want) == len(c["args"]["chunk_cnt"])
    got = kdec.stage_sums(kdec.decode_chunks(**c["args"], stages=stage))
    assert got.tolist() == want
    launch = kdec.decode_launcher(**c["args"])
    assert torch.equal(launch(stage), kdec.decode_chunks(**c["args"], stages=stage))
    out = launch(4)
    valid = torch.arange(c["C"])[None, :] < c["args"]["chunk_cnt"][:, None]
    assert out[valid].numpy().tobytes() == b"".join(s.tobytes() for _, s in c["kept"])


def test_stages_out_of_range_raise():
    n, c = 2, _stage_case(2)
    for bad in (0, 4):
        with pytest.raises(ValueError):
            kenc.encode_chunk_rows(c["blocks"], c["lens"], c["dense"], c["C"], n, stages=bad)
    for bad in (0, 5):
        with pytest.raises(ValueError):
            kdec.decode_chunks(**c["args"], stages=bad)
        with pytest.raises(ValueError):
            kdec.decode_launcher(**c["args"])(bad)


def test_tools_helpers_agree_with_definitions():
    """ablate.check_stages (the smoke run's and chip_smoke's check)
    passes on the plain versions and returns zeros for every stage."""
    inp = ablate.prepare(enwik_like(3 * 16384 + 100, 77), 3, "cpu", block_size=16384,
                         chunk_syms=128)
    errs = ablate.check_stages(inp)
    assert set(errs) == {"encode_stage1", "encode_stage2", "encode_stage3", "decode_stage1",
                         "decode_stage2", "decode_stage3", "decode_stage4"}
    assert not any(errs.values())
    with pytest.raises(ValueError):
        ablate.prepare(b"abc", 4, "cpu")


# ---- the tools as a user runs them

def _run(args):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, timeout=600)


@pytest.mark.parametrize("n", ARITIES)
def test_ablate_smoke_json(n):
    r = _run(["data_compression_tpu_torch.tools.ablate", str(n), "--smoke", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"smoke": True, "roundtrip_ok": True, "blocks": 2}


def test_microbench_smoke_json():
    r = _run(["data_compression_tpu_torch.tools.microbench", "--smoke", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(x) for x in r.stdout.strip().splitlines()]
    assert lines[-1] == {"smoke": True, "variants": 10, "ok": True}
    assert [x["variant"] for x in lines[:-1]] == list(kmb.VARIANTS)
    assert all(x["equal"] and x["device"] == "cpu" for x in lines[:-1])


def test_tools_import_no_jax():
    code = ("import sys\n"
            "import data_compression_tpu_torch.tools.ablate\n"
            "import data_compression_tpu_torch.tools.microbench\n"
            "print(sorted(m for m in sys.modules if m in ('jax', 'bench', 'data_compression_tpu')"
            " or m.startswith(('jax.', 'data_compression_tpu.'))))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": ROOT}, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_timing_needs_a_card(monkeypatch):
    """No measurement falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        timing.time_chain(lambda: None)
    with pytest.raises(RuntimeError):
        timing.cold_ms(lambda: None, 3, "cuda")
    with pytest.raises(RuntimeError):
        timing.device_ms(lambda: None)
    with pytest.raises(RuntimeError):
        timing.measure_envelope("cuda")
    with pytest.raises(RuntimeError):
        ablate.main(["2", "1"])
    with pytest.raises(RuntimeError):
        microbench.main(["--device", "cpu"])


def test_smoke_runs_default_to_the_card(monkeypatch):
    """Both tools' ``--smoke`` and ``smoke()`` run on cuda unless told
    otherwise: with no card they raise, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ablate.main(["2", "--smoke"]), lambda: ablate.smoke(2),
                 lambda: microbench.main(["--smoke"]), lambda: microbench.smoke()):
        with pytest.raises(RuntimeError):
            call()


class _Event:
    def __init__(self, device_type, us):
        self.device_type, self.device_time_total = device_type, us


def _fake_profiler(monkeypatch, sessions):
    """torch.profiler.profile replaced by sessions that hold the given
    device record counts (10 µs each, beside one host record); -> the
    list of counts the fake handed out."""
    from torch.autograd import DeviceType

    handed = []

    class Profile:
        def __init__(self, activities):
            self.n = next(sessions)
            handed.append(self.n)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [_Event(DeviceType.CPU, 99.0)] + [_Event(DeviceType.CUDA, 10.0)] * self.n

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(timing, "WINDOW_PAD_S", 0.0)
    return handed


def test_device_ms_takes_only_whole_sessions(monkeypatch):
    """``profiled_device_ms`` (whole API calls): one counting session (run
    again while empty) fixes the device records per call; a timed session
    that holds fewer than iters times that many is run again."""
    iters = 5
    handed = _fake_profiler(monkeypatch, iter([0, 2, 2 * iters - 1, 2 * iters, 99]))
    monkeypatch.setattr(timing, "WINDOW_PAD_S", 0.25)
    monkeypatch.setattr(timing, "MAX_WINDOW_PAD_S", 1.0)
    pads = []
    monkeypatch.setattr(timing.time, "sleep", pads.append)
    calls = []
    ms = timing.profiled_device_ms(lambda: calls.append(1), iters=iters)
    assert ms == pytest.approx(2 * iters * 10.0 / iters * 1e-3)
    assert handed == [0, 2, 2 * iters - 1, 2 * iters]
    assert len(calls) == 1 + 1 + 1 + 2 * iters  # warm-up, two counting, two timed sessions
    # each session idles at both ends; the pad doubles after a session
    # that is not whole, up to its cap
    assert pads == [0.25, 0.25, 0.5, 0.5, 0.5, 0.5, 1.0, 1.0]


def test_device_ms_raises_when_no_session_is_whole(monkeypatch):
    iters = 4
    _fake_profiler(monkeypatch, iter([3] + [3 * iters - 2] * timing.PROFILE_SESSIONS))
    short = ", ".join(["10"] * timing.PROFILE_SESSIONS)
    with pytest.raises(RuntimeError, match=rf"held \[3\] .*12 were expected.*\[{short}\]"):
        timing.profiled_device_ms(lambda: None, iters=iters)
    _fake_profiler(monkeypatch, iter([0] * timing.PROFILE_SESSIONS))
    with pytest.raises(timing.IncompleteProfile, match="no whole session"):
        timing.profiled_device_ms(lambda: None, iters=iters)
    # readings that check nothing take None (not measured) with a warning
    _fake_profiler(monkeypatch, iter([0] * timing.PROFILE_SESSIONS + [1, iters]))
    with pytest.warns(RuntimeWarning, match="device time not measured"):
        assert timing.profiled_device_ms_or_none(lambda: None, iters=iters) is None
    assert timing.profiled_device_ms_or_none(lambda: None, iters=iters) == pytest.approx(10.0 * 1e-3)


def _fake_card(monkeypatch, held, elapsed_ms=2.0):
    """CUDA events, the spin kernel and the sync debug mode faked: the
    gate of the k-th gated chain held when ``held[k]`` (its start event
    not reached when the host has enqueued the end event); every event
    pair spans ``elapsed_ms``.  -> (spins in cycles, the debug mode at each
    step call)."""
    held = iter(held)
    spins, state = [], {"mode": 0}

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def synchronize(self):
            pass

        def query(self):
            return not next(held)

        def elapsed_time(self, other):
            return elapsed_ms

    def set_mode(mode):
        state["mode"] = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep", spins.append)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["mode"])
    monkeypatch.setattr(timing, "_cycles_per_ms", None)
    return spins, state


def test_device_ms_times_the_calls_behind_a_gate(monkeypatch):
    """One spin calibrates the clock (``CALIBRATION_CYCLES`` over the
    events' 2 ms), then one gated chain of ``iters`` calls, each call in
    sync debug mode "error", the caller's mode back afterwards."""
    spins, state = _fake_card(monkeypatch, [True])
    state["mode"] = 1
    modes = []
    iters = 8
    ms = timing.device_ms(lambda: modes.append(state["mode"]), iters=iters)
    assert ms == pytest.approx(2.0 / iters)
    assert modes == [1] * (1 + iters) + [2] * iters  # warm-up, untimed and gated chains
    assert state["mode"] == 1
    per_ms = timing.CALIBRATION_CYCLES / 2.0
    assert spins[0] == timing.CALIBRATION_CYCLES and len(spins) == 2
    assert spins[1] >= int(timing.GATE_MIN_MS * per_ms)


def test_device_ms_lengthens_a_gate_that_did_not_hold(monkeypatch):
    """A chain whose start event was already reached is run again behind
    a spin 4x longer; after ``GATE_TRIES`` such chains it raises."""
    spins, _ = _fake_card(monkeypatch, [False, False, True])
    assert timing.device_ms(lambda: None, iters=3) == pytest.approx(2.0 / 3)
    gates = spins[1:]
    assert len(gates) == 3 and gates[1] == pytest.approx(4 * gates[0], rel=1e-6)
    assert gates[2] == pytest.approx(16 * gates[0], rel=1e-6)
    _fake_card(monkeypatch, [False] * timing.GATE_TRIES)
    with pytest.raises(timing.UngatedChain, match="outlasted every spin"):
        timing.device_ms(lambda: None, iters=3)


def test_device_ms_refuses_a_step_that_reads_back(monkeypatch):
    """A step that synchronises raises in sync debug mode "error" (as
    torch does), and the mode is restored."""
    _, state = _fake_card(monkeypatch, [True])

    def step():
        if state["mode"] == 2:
            raise RuntimeError("called a synchronizing CUDA operation")

    with pytest.raises(RuntimeError, match="synchronizing"):
        timing.device_ms(step, iters=4)
    assert state["mode"] == 0
