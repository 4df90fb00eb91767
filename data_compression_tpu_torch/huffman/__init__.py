from data_compression_tpu_torch.huffman.tree import (
    huffman_lengths,
    dummy_node_count,
)
from data_compression_tpu_torch.huffman.canonical import (
    CanonicalTable,
    lengths_to_codes,
    build_decode_tables,
    expected_payload_digits,
)
