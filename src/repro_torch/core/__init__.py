"""Clustering core (counterpart of ``repro.core``): the mean index, the
update step and state, the assignment algorithms, EstParams and the Lloyd
driver."""
