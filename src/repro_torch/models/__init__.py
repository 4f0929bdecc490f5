"""Model substrate: stage-list models over param dicts (NHWC at stage
boundaries, as in the JAX package)."""
