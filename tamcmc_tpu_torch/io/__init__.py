"""Host-side IO: spectrum data, problem files and their validation, and
the sampler's outputs."""
