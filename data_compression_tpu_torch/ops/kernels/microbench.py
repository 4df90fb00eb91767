"""Table-lookup microbenchmark variants (kernel: ``csrc/microbench.cu``).

Replaces the TPU kernels of ``tools/microbench.py`` (``run_variant.go``
with the bodies ``k0`` ... ``k7``): ten formulations of the encoder's
256-entry per-block table lookup, run over a [B, C, 128] uint8 symbol
tensor ``s`` and written as [B, C, 128] uint8.  With
``T_b = table[b, 2r:2r+2]`` flattened to 256 entries (``r`` = 0, 1, 2 for
the three lookups of ``gather256_u8_x3``, else 0):

  passthrough                 s
  widen_i32                   (int32(s) & 0xFF) as uint8
  gather256_i32 / _prebroadcast / _vreg_loop, gather256_u8, gather256_i16
                              T_b[s] & 0xFF
  gather128_i32_single        T_b[s & 127] & 0xFF
  gather256_u8_x3             T_b0[s] ^ T_b1[s] ^ T_b2[s]
  stage1_like                 p = T_b[s]; l = p >>> 15; w = p & 0x7FFF;
                              zero both unless pos < clip(65536 - lane*C, 0, C)
                              (pos = index along C, lane = index along 128);
                              (w ^ l) & 0xFF

Tables: none for the first two; ``TABLES[name]`` gives the dtype and row
count of the others ([B, 2, 128] int32, [B, 6, 128] uint8 or [B, 4, 128]
int16).  ``REPLACES[name]`` is the TPU body the variant ports.  Each
variant has its own wrapper, ``WRAPPERS[name]``, with its own
``launches`` count; ``lookup_variant(name, ...)`` calls it.
"""

from __future__ import annotations

import torch

from data_compression_tpu_torch.ops.kernels import _build

LANES = 128
_SLICE_BYTES = 8192  # bytes of one block per CTA (csrc/microbench.cu)
_I32 = (torch.int32, 2)
# variant (in kernel-index order): its table's dtype and row count, or
# None; the line of its body in the JAX package's tools/microbench.py
_SPECS = {
    "passthrough": (None, 75),
    "widen_i32": (None, 80),
    "gather256_i32": (_I32, 86),
    "gather128_i32_single": (_I32, 98),
    "gather256_u8": ((torch.uint8, 6), 107),
    "gather256_u8_x3": ((torch.uint8, 6), 118),
    "gather256_i16": ((torch.int16, 4), 135),
    "gather256_i32_prebroadcast": (_I32, 147),
    "gather256_i32_vreg_loop": (_I32, 159),
    "stage1_like": (_I32, 172),
}
VARIANTS = tuple(_SPECS)
TABLES = {name: table for name, (table, _) in _SPECS.items()}
REPLACES = {name: f"tools/microbench.py:{line}" for name, (_, line) in _SPECS.items()}


def _check(name, s, table):
    if name not in TABLES:
        raise ValueError(f"unknown lookup variant {name!r}")
    if s.dtype != torch.uint8 or s.dim() != 3 or s.shape[2] != LANES:
        raise ValueError(f"s must be [B, C, {LANES}] uint8, got {s.dtype} {tuple(s.shape)}")
    B, C, _ = s.shape
    if C <= 0 or (C * LANES) % _SLICE_BYTES:
        raise ValueError(f"C = {C} must be a positive multiple of {_SLICE_BYTES // LANES}")
    spec = TABLES[name]
    if spec is None:
        if table is not None:
            raise ValueError(f"variant {name} takes no table")
    elif table is None or table.dtype != spec[0] or tuple(table.shape) != (B, spec[1], LANES):
        raise ValueError(f"variant {name} needs a [{B}, {spec[1]}, {LANES}] {spec[0]} table")
    return B, C


def lookup_variant_ref(name, s, table=None):
    """Plain PyTorch version (any device): ``torch.gather`` on the
    flattened table."""
    B, C = _check(name, s, table)
    if name == "passthrough":
        return s.clone()
    if name == "widen_i32":
        return (s.to(torch.int32) & 0xFF).to(torch.uint8)
    idx = s.reshape(B, C * LANES).long()
    flat = table.reshape(B, -1)
    if name == "gather128_i32_single":
        w = torch.gather(flat[:, :128], 1, idx & 127)
    elif name == "gather256_u8_x3":
        w = (torch.gather(flat[:, :256], 1, idx) ^ torch.gather(flat[:, 256:512], 1, idx)
             ^ torch.gather(flat[:, 512:768], 1, idx))
    elif name == "stage1_like":
        p = torch.gather(flat[:, :256], 1, idx).long() & 0xFFFFFFFF  # logical >>
        o = torch.arange(C * LANES, device=s.device)
        cc = (65536 - (o % LANES) * C).clamp(0, C)
        w = torch.where(o // LANES < cc, (p & 0x7FFF) ^ (p >> 15), 0)
    else:
        w = torch.gather(flat[:, :256], 1, idx)
    return (w & 0xFF).to(torch.uint8).view(B, C, LANES)


def _make_wrapper(name):
    variant = VARIANTS.index(name)

    def wrapper(s, table=None):
        """Run the variant on the tensors' device: the CUDA kernel for
        CUDA tensors, the plain version for CPU tensors."""
        if s.device.type == "cpu":
            return lookup_variant_ref(name, s, table)
        B, C = _check(name, s, table)
        _build.require_cuda(s, *(() if table is None else (table,)))
        out = torch.empty_like(s)
        if s.data_ptr() % 16 or out.data_ptr() % 16:
            raise ValueError("lookup kernels need 16-byte aligned tensors")
        if B:
            with torch.cuda.device(s.device):
                rc = _build.lib().dct_lookup(
                    variant, s.data_ptr(), None if table is None else table.data_ptr(),
                    out.data_ptr(), B, C, _build.stream_of(s),
                )
            _build.check(rc, f"lookup {name}")
            wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = f"lookup_{name}"
    wrapper.launches = 0
    return wrapper


WRAPPERS = {name: _make_wrapper(name) for name in VARIANTS}


def lookup_variant(name, s, table=None):
    """Variant ``name`` on the tensors' device (see ``WRAPPERS``)."""
    if name not in WRAPPERS:
        raise ValueError(f"unknown lookup variant {name!r}")
    return WRAPPERS[name](s, table)
