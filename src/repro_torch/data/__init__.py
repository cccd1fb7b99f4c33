"""Synthetic corpora, the UCI bag-of-words loader and the sharded batch
pipeline (counterpart of ``repro.data``)."""
from repro_torch.data.loader import load_uci_bow
from repro_torch.data.pipeline import ShardedBatches
from repro_torch.data.synthetic import CorpusSpec, make_corpus

__all__ = ["CorpusSpec", "ShardedBatches", "load_uci_bow", "make_corpus"]
