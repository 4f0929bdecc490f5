"""Numpy data pipeline, copied from ``repro.data`` so that both packages
draw identical arrays from one seed."""
