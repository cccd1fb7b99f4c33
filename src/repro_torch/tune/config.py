"""The knob vector the autotuner searches over (counterpart of
``repro.tune.config``).

``repro``'s knobs are the Pallas grid's block geometry.  Here they are the
tile settings of the two hand-written gathers in ``csrc/gather.cu``:
``sparse_sim`` (``gather_tiled<kSims>``) and ``esicp_gather``
(``gather_tiled<kEsicp>``), whose one launch per batch the fits repeat.
A setting picks the documents a tile holds and the columns of its slab;
``slab_fastest`` puts the column slabs fastest in the grid in place of the
tiles (``gather_setting_launch``'s settings 4-7).  Every setting sums each
document's slots in slot order, so a setting changes the launch, never
the sums: a tuned fit equals the untuned one bit for bit.

``DEFAULT_TUNED`` (all zeros) launches exactly what the wrappers launch
without a config.  The square and per-row-threshold variants keep setting
0: they have no other.

A :class:`TunedConfig` is hashable and JSON-serializable (it rides the
fitted artifact and the process cache).  Its ``engine`` is ``"cuda"``
only: ``repro``'s ``"pallas"`` and ``"xla_blocked"`` configs describe
another machine's kernels and are refused, as ``repro`` keeps its own two
engines apart.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.esicp_gather import ESICP, SIMS

ENGINE = "cuda"
ENGINES = (ENGINE,)

#: gather.cu's tile table (``tile_docs`` and ``launch_setting``): per
#: gather, per setting 0-3, (documents per tile, columns per slab).
TILES = {
    "sims": ((28, 256), (32, 256), (64, 256), (28, 128)),
    "esicp": ((14, 256), (7, 256), (16, 256), (28, 128)),
}
#: gather.cu's mode number of each gather.
MODES = {"sims": SIMS, "esicp": ESICP}
#: (gather, with counts) -> the settings 0-3 gather.cu instantiates.  ESICP
#: without counts, which no fit launches, has setting 0 only.
INSTANTIATED = {("sims", False): 4, ("sims", True): 4,
                ("esicp", False): 1, ("esicp", True): 4}
#: The grid order adds 4 to a setting.
SLAB_FASTEST = 4


def instantiated(gather: str, counts: bool, setting: int) -> bool:
    """Does gather.cu launch ``gather`` (with counts or not) at
    ``setting`` (0-7)?"""
    return 0 <= setting < 2 * SLAB_FASTEST and \
        setting % SLAB_FASTEST < INSTANTIATED[(gather, bool(counts))]


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One candidate (or winning) setting of the gathers.

    sims_setting:  0-3, the tile of ``gather_tiled<kSims>``.
    esicp_setting: 0-3, the tile of ``gather_tiled<kEsicp>``.
    slab_fastest:  the grid order of both: column slabs fastest.
    engine:        ``"cuda"``.
    source:        provenance: 'default' | 'search' | 'cache' | 'manual'.
    signature:     the corpus signature it was tuned for (tune/cache.py);
                   '' for untuned configs.
    """

    sims_setting: int = 0
    esicp_setting: int = 0
    slab_fastest: bool = False
    engine: str = ENGINE
    source: str = "default"
    signature: str = ""

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got "
                             f"{self.engine!r} (a config tuned for another "
                             f"engine does not apply to these kernels)")
        for name in ("sims", "esicp"):
            s = getattr(self, f"{name}_setting")
            if type(s) is not int or not 0 <= s < len(TILES[name]):
                raise ValueError(f"{name}_setting must be an int in "
                                 f"[0, {len(TILES[name])}), got {s!r}")
        if type(self.slab_fastest) is not bool:
            raise ValueError(f"slab_fastest must be a bool, got "
                             f"{self.slab_fastest!r}")

    def launch_setting(self, gather: str) -> int:
        """The ``gather_setting_launch`` setting of ``gather`` ('sims' or
        'esicp'): its tile, plus 4 with the slabs fastest."""
        return (getattr(self, f"{gather}_setting")
                + SLAB_FASTEST * self.slab_fastest)

    def replace(self, **changes) -> TunedConfig:
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> TunedConfig:
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def geometry_key(self, *, b: int, p: int, d: int, k: int) -> tuple:
        """The launches this config makes at a shape: per gather its
        documents per tile and columns per slab, and the grid order where
        it matters (some gather has more than one tile and more than one
        slab).  Two configs with the same key launch the same programs on
        the same grid, so the search times one of them."""
        geo = [TILES[g][getattr(self, f"{g}_setting")] for g in TILES]
        order = any(-(-b // bt) > 1 and -(-k // kt) > 1 for bt, kt in geo)
        return (self.engine, *geo, self.slab_fastest and order)


DEFAULT_TUNED = TunedConfig()


def default_tuned() -> TunedConfig:
    """The search's incumbent: what the wrappers launch untuned."""
    return DEFAULT_TUNED
