"""Command-line interface (counterpart of ``data_compression_tpu/cli.py``;
the same flags write the same bytes).

Usage:
  python -m data_compression_tpu_torch compress   [-c CODEC] [-n ARITY] [opts] [--device D] IN OUT
  python -m data_compression_tpu_torch decompress [--device D] IN OUT
  python -m data_compression_tpu_torch roundtrip  [-c CODEC] [-n ARITY] [opts] [--device D] IN
  python -m data_compression_tpu_torch info       IN
  python -m data_compression_tpu_torch armor      [-a base64url|z85|ascii85] IN OUT
  python -m data_compression_tpu_torch dearmor    IN OUT
  (use '-' for stdin/stdout; the device defaults to cuda)

Codecs (``-c``): huffman, literal, nybble, small_byte, small_nybble; the
serial ones run on the host whatever the device.  ``compress`` streams:
one independent frame per ``--batch-blocks`` blocks read (``--printable``
armors each frame), so at most one batch is resident.  ``decompress``
and ``info`` read frame by frame, binary or printable.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from data_compression_tpu_torch import api, framing
from data_compression_tpu_torch.config import CODEC_IDS, CodecConfig
from data_compression_tpu_torch.utils import base64url as b64


def _read(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _open_in(path: str):
    return sys.stdin.buffer if path == "-" else open(path, "rb")


def _open_out(path: str):
    return sys.stdout.buffer if path == "-" else open(path, "wb")


def _close(f, path: str) -> None:
    """Close a file opened by ``_open_in`` / ``_open_out``; flush stdout."""
    if path != "-":
        f.close()
    elif f is sys.stdout.buffer:
        f.flush()


def _write(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            f.write(data)


def _config(args) -> CodecConfig:
    return CodecConfig(
        codec=args.codec,
        arity=args.arity,
        block_size=args.block_size,
        chunk_syms=args.chunk_syms,
        shared_table=args.shared_table,
        isprint_literal=args.isprint_literal,
    )


def _stats(args):
    """A CodecStats for ``--stats`` on a serial codec, else None."""
    if not args.stats:
        return None
    if args.codec not in api.STATS_CODECS:
        print(f"--stats supports codecs {api.STATS_CODECS}; ignored for {args.codec}",
              file=sys.stderr)
        return None
    from data_compression_tpu_torch.utils.debug import CodecStats

    return CodecStats(16 if args.codec == "nybble" else 32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="data_compression_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")

    def add_codec_flags(sp):
        sp.add_argument("-c", "--codec", default="huffman", choices=sorted(CODEC_IDS))
        sp.add_argument("-n", "--arity", type=int, default=2,
                        help="huffman arity, 2-64 (2/3/16 run the CUDA kernels; "
                        "other n ride the host path)")
        sp.add_argument("--block-size", type=int, default=64 * 1024)
        sp.add_argument("--chunk-syms", type=int, default=512)
        sp.add_argument("--shared-table", action="store_true")
        sp.add_argument(
            "--isprint-literal", action="store_true",
            help="small_byte: ISPRINT_IS_ALWAYS_LITERAL (0x1f) block "
            "mode for all-printable blocks (small_compression.c:36)",
        )
        sp.add_argument(
            "--stats", action="store_true",
            help="serial codecs (nybble/small_*): print per-context "
            "prediction/dictionary hit rates after compress (the "
            "reference's times_used_directly counters, "
            "nybble_compression.c:543); routes encode through the "
            "host path",
        )
        add_device(sp)

    sp = sub.add_parser("compress", help="compress IN to OUT")
    add_codec_flags(sp)
    sp.add_argument(
        "--printable", action="store_true",
        help="emit the in-band printable container (every block payload "
        "an independent Z85 span), one armored container per frame",
    )
    sp.add_argument(
        "--batch-blocks", type=int, default=api.DEFAULT_BATCH_BLOCKS,
        help="blocks resident per streamed batch; one frame each (bounds memory)",
    )
    sp.add_argument("input")
    sp.add_argument("output")

    sp = sub.add_parser("decompress", help="decompress IN to OUT")
    add_device(sp)
    sp.add_argument("input")
    sp.add_argument("output")

    sp = sub.add_parser("roundtrip", help="compress+decompress+verify IN")
    add_codec_flags(sp)
    sp.add_argument("input")

    sp = sub.add_parser("info", help="print stream header as JSON")
    sp.add_argument("input")

    sp = sub.add_parser(
        "armor", help="encode bytes as printable text (base64url, z85 or ascii85)"
    )
    sp.add_argument("-a", "--alphabet", default="base64url",
                    choices=["base64url", "z85", "ascii85"])
    sp.add_argument("input")
    sp.add_argument("output")

    sp = sub.add_parser("dearmor", help="decode printable armor to bytes")
    sp.add_argument("input")
    sp.add_argument("output")

    args = p.parse_args(argv)

    if args.cmd == "compress":
        stats = _stats(args)
        fin, fout = _open_in(args.input), _open_out(args.output)
        try:
            t0 = time.perf_counter()
            st = api.compress_stream(
                fin, fout, _config(args), batch_blocks=args.batch_blocks,
                printable=args.printable, stats=stats, device=args.device,
            )
            dt = time.perf_counter() - t0
        finally:
            _close(fin, args.input)
            _close(fout, args.output)
        print(
            f"{st['raw_bytes']} -> {st['compressed_bytes']} bytes "
            f"(ratio {st['ratio']:.4f}, {dt:.3f}s on {args.device}, "
            f"{st['raw_bytes']/max(dt,1e-9)/1e6:.1f} MB/s, {st['frames']} frame(s))",
            file=sys.stderr,
        )
        if stats is not None:
            print(f"stats: {stats.summary()}", file=sys.stderr)
        return 0

    if args.cmd == "decompress":
        fin, fout = _open_in(args.input), _open_out(args.output)
        try:
            t0 = time.perf_counter()
            st = api.decompress_stream(fin, fout, device=args.device)
            dt = time.perf_counter() - t0
        finally:
            _close(fin, args.input)
            _close(fout, args.output)
        print(f"{st['compressed_bytes']} -> {st['raw_bytes']} bytes ({dt:.3f}s on "
              f"{args.device}, {st['frames']} frame(s))", file=sys.stderr)
        return 0

    if args.cmd == "roundtrip":
        data = _read(args.input)
        stats = _stats(args)
        out = api.compress(data, _config(args), device=args.device, stats=stats)
        ok = api.decompress(out, device=args.device) == data
        print(
            f"{'OK' if ok else 'MISMATCH'}: {len(data)} -> {len(out)} "
            f"(ratio {len(out)/max(1,len(data)):.4f})",
            file=sys.stderr,
        )
        if stats is not None:
            print(f"stats: {stats.summary()}", file=sys.stderr)
        return 0 if ok else 1

    if args.cmd == "armor":
        data = _read(args.input)
        enc = {"base64url": b64.armor, "z85": b64.z85_armor,
               "ascii85": b64.ascii85_armor}[args.alphabet]
        _write(args.output, enc(data).encode("ascii"))
        return 0

    if args.cmd == "dearmor":
        text = _read(args.input).decode("ascii")
        if text.startswith("DCZ:"):
            out = b64.z85_dearmor(text)
        elif text.startswith("DCA:"):
            out = b64.ascii85_dearmor(text)
        else:
            out = b64.dearmor(text)
        _write(args.output, out)
        return 0

    if args.cmd == "info":
        # a streamed container is a concatenation of frames: summarise
        # all, one frame resident at a time
        info = None
        fin = _open_in(args.input)
        try:
            while True:
                fb = framing.read_frame(fin)
                if fb is None:
                    break
                f = framing.unpack_frame(fb)
                if info is None:
                    info = {"codec": f.codec_name, "arity": f.arity,
                            "block_size": f.block_size, "frames": 0, "total_len": 0,
                            "num_blocks": 0, "shared_table": f.shared_table is not None,
                            "literal_blocks": 0, "compressed_bytes": 0}
                info["frames"] += 1
                info["total_len"] += f.total_len
                info["num_blocks"] += len(f.entries)
                info["literal_blocks"] += sum(e.is_literal for e in f.entries)
                info["compressed_bytes"] += sum(e.comp_len for e in f.entries)
        finally:
            _close(fin, args.input)
        if info is None:
            print(json.dumps({"error": "no frames"}))
            return 1
        print(json.dumps(info))
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
