"""Model configurations the port can run (``registry.ARCHS``), and the
paper's two clustering jobs (``nyt1m``, ``pubmed8m``: ``KMeansJob``s,
not archs)."""
