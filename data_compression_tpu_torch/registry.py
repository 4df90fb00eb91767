"""Codec registry — maps codec names to implementations (all five
codecs of ``CODEC_IDS``); an unknown name raises ValueError."""

from __future__ import annotations

from typing import Dict

from data_compression_tpu_torch.config import CodecConfig

_REGISTRY: Dict[str, type] = {}


def register_codec(name: str, cls: type) -> None:
    _REGISTRY[name] = cls


def available_codecs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from data_compression_tpu_torch.models.huffman import HuffmanCodec
    from data_compression_tpu_torch.models.literal import LiteralCodec
    from data_compression_tpu_torch.models.nybble import NybbleCodec
    from data_compression_tpu_torch.models.small import SmallByteCodec, SmallNybbleCodec

    register_codec("literal", LiteralCodec)
    register_codec("nybble", NybbleCodec)
    register_codec("small_byte", SmallByteCodec)
    register_codec("small_nybble", SmallNybbleCodec)
    register_codec("huffman", HuffmanCodec)


def get_codec(config: CodecConfig, device="cuda"):
    _ensure_loaded()
    try:
        cls = _REGISTRY[config.codec]
    except KeyError:
        raise ValueError(f"unknown codec {config.codec!r}") from None
    return cls(config, device)
