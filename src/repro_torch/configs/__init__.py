"""Model configurations the port can run (``registry.ARCHS``)."""
