"""``repro_torch.tune`` — the autotuner of the gathers' tile settings
(counterpart of ``repro.tune``).

Public surface, ``repro``'s names:

* :class:`TunedConfig` / ``DEFAULT_TUNED`` / ``ENGINES`` /
  :func:`default_tuned` — the knob vector (tune/config.py).  There is one
  engine, ``"cuda"``, so ``repro``'s ``DEFAULT_XLA_TUNED`` has no
  counterpart;
* ``TUNED_CACHE`` / :func:`corpus_signature` — the process cache of
  winners keyed by the corpus regime (tune/cache.py);
* :func:`search_tuned_config` / :func:`ensure_tuned` / ``SearchBudget`` /
  ``SearchStats`` / :func:`candidate_space` — the roofline-pruned search
  (tune/search.py);
* the cost model lives in tune/cost.py.

``search`` pulls in the kernel wrappers, so it is re-exported lazily:
the package stays cheap to import and free of import cycles.
"""
from __future__ import annotations

from repro_torch.tune.cache import TUNED_CACHE, corpus_signature
from repro_torch.tune.config import (DEFAULT_TUNED, ENGINES, TunedConfig,
                                     default_tuned)

__all__ = [
    "TunedConfig", "DEFAULT_TUNED", "ENGINES", "default_tuned",
    "TUNED_CACHE", "corpus_signature", "SearchBudget", "SearchStats",
    "search_tuned_config", "ensure_tuned", "candidate_space",
]

_LAZY = {"SearchBudget", "SearchStats", "search_tuned_config",
         "ensure_tuned", "candidate_space"}


def __getattr__(name: str):
    if name in _LAZY:
        from repro_torch.tune import search

        return getattr(search, name)
    raise AttributeError(f"module 'repro_torch.tune' has no attribute "
                         f"{name!r}")
