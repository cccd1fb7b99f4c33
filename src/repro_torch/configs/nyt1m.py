"""The paper's second workload: 1M-sized NYT, K = 10 000 (§VI-A); the
port's copy of ``repro.configs.nyt1m``.  ``chip_smoke.py`` takes its
corpus widths from :func:`config`."""
from repro_torch.configs.pubmed8m import KMeansJob
from repro_torch.data.synthetic import CorpusSpec


def config() -> KMeansJob:
    return KMeansJob(name="nyt1m", n_docs=1_285_944, vocab=495_126,
                     k=10_000, nt_mean=225.76)


def reduced(seed: int = 0) -> KMeansJob:
    spec = CorpusSpec(n_docs=10_000, vocab=16_384, nt_mean=120.0,
                      n_topics=100, seed=seed)
    return KMeansJob(name="nyt60k-reduced", n_docs=spec.n_docs,
                     vocab=spec.vocab, k=100, nt_mean=spec.nt_mean,
                     corpus=spec, max_iter=40, obj_chunk=1024)
