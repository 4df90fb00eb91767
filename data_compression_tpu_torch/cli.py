"""Command-line interface (counterpart of ``data_compression_tpu/cli.py``
for whole files).

Usage:
  python -m data_compression_tpu_torch compress   [-n ARITY] [opts] [--device D] IN OUT
  python -m data_compression_tpu_torch decompress [--device D] IN OUT
  python -m data_compression_tpu_torch roundtrip  [-n ARITY] [opts] [--device D] IN
  python -m data_compression_tpu_torch info       IN
  (use '-' for stdin/stdout; the device defaults to cuda)

``decompress`` and ``info`` read every frame of a file, so the JAX
package's streamed containers (concatenated frames) work too.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

from data_compression_tpu_torch import api, framing
from data_compression_tpu_torch.config import CODEC_IDS, CodecConfig


def _read(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            f.write(data)


def _frames(data: bytes):
    """The binary frames of a container file, in order."""
    stream = io.BytesIO(data)
    frames = []
    while True:
        fb = framing.read_frame(stream)
        if fb is None:
            return frames
        frames.append(fb)


def _config(args) -> CodecConfig:
    return CodecConfig(
        codec=args.codec,
        arity=args.arity,
        block_size=args.block_size,
        chunk_syms=args.chunk_syms,
        shared_table=args.shared_table,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="data_compression_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")

    def add_codec_flags(sp):
        sp.add_argument("-c", "--codec", default="huffman", choices=sorted(CODEC_IDS))
        sp.add_argument("-n", "--arity", type=int, default=2)
        sp.add_argument("--block-size", type=int, default=64 * 1024)
        sp.add_argument("--chunk-syms", type=int, default=512)
        sp.add_argument("--shared-table", action="store_true")
        add_device(sp)

    sp = sub.add_parser("compress", help="compress IN to OUT")
    add_codec_flags(sp)
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

    args = p.parse_args(argv)

    if args.cmd == "compress":
        data = _read(args.input)
        t0 = time.perf_counter()
        out = api.compress(data, _config(args), device=args.device)
        dt = time.perf_counter() - t0
        _write(args.output, out)
        print(
            f"{len(data)} -> {len(out)} bytes (ratio {len(out)/max(1,len(data)):.4f}, "
            f"{dt:.3f}s on {args.device})",
            file=sys.stderr,
        )
        return 0

    if args.cmd == "decompress":
        frames = _frames(_read(args.input))
        if not frames:
            raise ValueError("empty input: no frames")
        t0 = time.perf_counter()
        out = b"".join(api.decompress(f, device=args.device) for f in frames)
        dt = time.perf_counter() - t0
        _write(args.output, out)
        print(f"{sum(map(len, frames))} -> {len(out)} bytes ({dt:.3f}s on {args.device})",
              file=sys.stderr)
        return 0

    if args.cmd == "roundtrip":
        data = _read(args.input)
        out = api.compress(data, _config(args), device=args.device)
        ok = api.decompress(out, device=args.device) == data
        print(
            f"{'OK' if ok else 'MISMATCH'}: {len(data)} -> {len(out)} "
            f"(ratio {len(out)/max(1,len(data)):.4f})",
            file=sys.stderr,
        )
        return 0 if ok else 1

    if args.cmd == "info":
        frames = [framing.unpack_frame(f) for f in _frames(_read(args.input))]
        if not frames:
            print(json.dumps({"error": "no frames"}))
            return 1
        f0 = frames[0]
        print(
            json.dumps(
                {
                    "codec": f0.codec_name,
                    "arity": f0.arity,
                    "block_size": f0.block_size,
                    "frames": len(frames),
                    "total_len": sum(f.total_len for f in frames),
                    "num_blocks": sum(len(f.entries) for f in frames),
                    "shared_table": f0.shared_table is not None,
                    "literal_blocks": sum(
                        e.is_literal for f in frames for e in f.entries
                    ),
                    "compressed_bytes": sum(
                        e.comp_len for f in frames for e in f.entries
                    ),
                }
            )
        )
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
