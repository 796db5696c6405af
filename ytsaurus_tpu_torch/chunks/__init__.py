from ytsaurus_tpu_torch.chunks.columnar import (  # noqa: F401
    Column,
    ColumnarChunk,
    chunk_from_numpy,
    next_pow2,
    pad_capacity,
)
