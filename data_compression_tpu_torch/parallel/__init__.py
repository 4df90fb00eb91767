from data_compression_tpu_torch.parallel.mesh import make_mesh
from data_compression_tpu_torch.parallel.pipeline import (
    compress_sharded,
    decompress_sharded,
)
