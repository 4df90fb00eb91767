"""Codec registry — maps codec names to implementations.  Only
``huffman`` is ported; every other codec of ``CODEC_IDS`` raises
NotImplementedError."""

from __future__ import annotations

from typing import Dict

from data_compression_tpu_torch.config import CODEC_IDS, CodecConfig

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

    register_codec("huffman", HuffmanCodec)


def get_codec(config: CodecConfig, device="cuda"):
    _ensure_loaded()
    try:
        cls = _REGISTRY[config.codec]
    except KeyError:
        if config.codec in CODEC_IDS:
            raise NotImplementedError(
                f"codec {config.codec!r} is not yet ported"
            ) from None
        raise ValueError(f"unknown codec {config.codec!r}") from None
    return cls(config, device)
