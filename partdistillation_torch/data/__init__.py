from .catalog import DatasetCatalog, DatasetSpec, Metadata
from .loader import DataLoader, batch_iterator, host_shard
from .pseudo_store import PseudoLabelStore, ShardWriter

__all__ = [
    "DatasetCatalog", "DatasetSpec", "Metadata",
    "DataLoader", "batch_iterator", "host_shard",
    "PseudoLabelStore", "ShardWriter",
]
