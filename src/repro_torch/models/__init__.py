"""Model substrate over param dicts: the stage-list CNN zoo (NHWC at
stage boundaries) and the decoder-only transformer (dense, MoE), in the
JAX package's layouts."""
