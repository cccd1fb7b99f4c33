"""Synthetic corpora (counterpart of ``repro.data``)."""
from repro_torch.data.synthetic import CorpusSpec, make_corpus

__all__ = ["CorpusSpec", "make_corpus"]
