"""Plain reference of the benchmark: n-ary canonical Huffman with
per-block tables in plain PyTorch.  It imports nothing of the program."""
