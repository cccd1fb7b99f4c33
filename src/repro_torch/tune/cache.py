"""Winning configs keyed by a shape/skew signature (counterpart of
``repro.tune.cache``).

A tuned config belongs to the *regime* a corpus puts the gathers in:
batch rows, tuple width, vocabulary, K, how skewed the occupancy is, and
the card.  The key buckets exactly those, in ``repro``'s format, so two
corpora of one regime share one search, across fits and (through the
fitted artifact) across processes.  The platform field is the card's name
(``torch.cuda.get_device_name``) for CUDA operands and ``"cpu"``
otherwise, where ``repro`` writes ``jax.default_backend()``; the engine
suffix is ``cuda``.

The cache is a plain in-process dict: ``KernelBackend.prepare`` consults
it on every fit with ``tune != 'off'``, a search fills it on a miss, and
``FittedModel.load`` and the servable re-seed it from an artifact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tune.config import ENGINE, TunedConfig


def _pow2_bucket(n: int) -> int:
    """Round up to the next power of two: row counts land in stable
    buckets whatever their residue."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def occupancy_fraction(ids, vals, *, dim: int, b_blk: int = 128,
                       d_blk: int = 256) -> float:
    """Fraction of (b_blk row-group, d_blk D-block) cells holding at least
    one live tuple, on the host, at ``repro``'s default geometry (so the
    statistic is ``repro``'s)."""
    ids = _host(ids)
    vals = _host(vals)
    b, p = ids.shape
    nb = -(-b // b_blk)
    nd = -(-dim // d_blk)
    occ = np.zeros((nb, nd), np.bool_)
    grp = np.repeat(np.arange(nb), b_blk)[:b]
    blk = np.minimum(ids // d_blk, nd - 1)
    live = vals != 0.0
    occ[np.broadcast_to(grp[:, None], blk.shape)[live], blk[live]] = True
    return float(occ.mean()) if occ.size else 0.0


def platform_of(ids) -> str:
    """The card's name for a CUDA tensor, else ``"cpu"``."""
    if torch.is_tensor(ids) and ids.device.type == "cuda":
        return torch.cuda.get_device_name(ids.device)
    return "cpu"


def corpus_signature(ids, vals, *, dim: int, k: int) -> str:
    """Cache key: platform / bucketed B / P / D / K / bucketed occupancy /
    engine, in ``repro``'s format.  Occupancy is bucketed to 0.05 so small
    perturbations of a corpus (reshuffles, appends) still hit."""
    b, p = tuple(ids.shape)
    occ = occupancy_fraction(ids, vals, dim=dim)
    occ_bucket = round(round(occ / 0.05) * 0.05, 2)
    return (f"{platform_of(ids)}/b{_pow2_bucket(b)}/p{_pow2_bucket(p)}/"
            f"d{dim}/k{k}/occ{occ_bucket:.2f}/{ENGINE}")


class TunedConfigCache:
    """signature -> TunedConfig, with a dict round trip for persistence.
    ``searches`` counts the searches :func:`repro_torch.tune.ensure_tuned`
    ran to fill it and ``last_search`` keeps the last one's
    :class:`~repro_torch.tune.SearchStats`; ``clear`` resets both."""

    def __init__(self):
        self._store: dict[str, TunedConfig] = {}
        self.searches = 0
        self.last_search = None

    def get(self, signature: str) -> TunedConfig | None:
        return self._store.get(signature)

    def put(self, signature: str, cfg: TunedConfig) -> TunedConfig:
        cfg = cfg.replace(signature=signature)
        self._store[signature] = cfg
        return cfg

    def clear(self) -> None:
        self._store.clear()
        self.searches = 0
        self.last_search = None

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, signature: str) -> bool:
        return signature in self._store

    def to_dict(self) -> dict:
        return {sig: cfg.to_dict() for sig, cfg in self._store.items()}

    def from_dict(self, d: dict) -> None:
        for sig, cfg in d.items():
            self._store[sig] = TunedConfig.from_dict(cfg)


#: The process-wide cache every ``KernelBackend.prepare`` consults.
TUNED_CACHE = TunedConfigCache()
