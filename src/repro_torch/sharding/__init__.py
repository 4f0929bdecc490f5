"""Placement on a device mesh: the path-rule specs (``specs``) and the
collectives every cross-rank value passes through (``collectives``)."""
