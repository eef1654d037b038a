"""Padded batches on a device."""
from packppi_torch.data.batch import (  # noqa: F401
    LENGTH_BUCKETS,
    ProteinBatch,
    bucket_length,
    pad_features,
    stack_batch,
)
