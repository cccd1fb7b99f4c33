"""Synthetic corpora and the UCI bag-of-words loader (counterpart of
``repro.data``)."""
from repro_torch.data.loader import load_uci_bow
from repro_torch.data.synthetic import CorpusSpec, make_corpus

__all__ = ["CorpusSpec", "load_uci_bow", "make_corpus"]
