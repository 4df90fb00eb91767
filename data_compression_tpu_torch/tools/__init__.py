"""Profiling tools of the port, run as modules:

  python -m data_compression_tpu_torch.tools.ablate [arity] [mb] [--out FILE] [--smoke] [--device D]
  python -m data_compression_tpu_torch.tools.microbench [--smoke] [--device D]

Counterparts of the JAX package's ``tools/ablate.py`` and
``tools/microbench.py``.  They time on a CUDA device (``timing``); with
``--smoke`` they run a tiny check instead, on ``--device`` (default
cuda, as every entry point; ``--device cpu`` runs the plain versions).
"""
