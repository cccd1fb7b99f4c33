"""The paper's own workload: 8.2M-sized PubMed, K = 80 000 (§VI-A); the
port's copy of ``repro.configs.pubmed8m``.

Full-scale shapes size a run; ``reduced()`` is a corpus with the same
universal characteristics that a CPU fits in seconds.  Kept out of
``registry.ARCHS``: a clustering job, not an LM.
"""
import dataclasses

from repro_torch.data.synthetic import CorpusSpec


@dataclasses.dataclass(frozen=True)
class KMeansJob:
    name: str
    n_docs: int
    vocab: int
    k: int
    nt_mean: float
    corpus: CorpusSpec | None = None   # None: full scale, no corpus spec
    max_iter: int = 64
    obj_chunk: int = 4096


def config() -> KMeansJob:
    return KMeansJob(name="pubmed8m", n_docs=8_200_000, vocab=141_043,
                     k=80_000, nt_mean=58.96)


def reduced(seed: int = 0) -> KMeansJob:
    spec = CorpusSpec(n_docs=20_000, vocab=8_192, nt_mean=60.0,
                      n_topics=200, seed=seed)
    return KMeansJob(name="pubmed120k-reduced", n_docs=spec.n_docs,
                     vocab=spec.vocab, k=200, nt_mean=spec.nt_mean,
                     corpus=spec, max_iter=40, obj_chunk=1024)
