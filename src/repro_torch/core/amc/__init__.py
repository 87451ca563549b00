"""Access-to-Miss Correlation (AMC) prefetcher — the paper's contribution."""
from repro_torch.core.amc.compression import (
    basedelta_compress,
    basedelta_decompress,
    compressed_entry_bytes,
    CompressionStats,
)
from repro_torch.core.amc.storage import AMCStorage, AMCEntryTable
from repro_torch.core.amc.prefetcher import AMCConfig, AMCPrefetcher
from repro_torch.core.amc.api import AMCSession

__all__ = [
    "basedelta_compress",
    "basedelta_decompress",
    "compressed_entry_bytes",
    "CompressionStats",
    "AMCStorage",
    "AMCEntryTable",
    "AMCConfig",
    "AMCPrefetcher",
    "AMCSession",
]
