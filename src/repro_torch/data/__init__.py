"""Data pipeline: deterministic synthetic corpora, packing, sharded loaders."""
from .pipeline import (DataConfig, SyntheticLM, MixtureDataset, pack_documents,
                       make_loader)

__all__ = ["DataConfig", "SyntheticLM", "MixtureDataset", "pack_documents",
           "make_loader"]
