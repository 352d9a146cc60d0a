"""Adaptive tempered MALA sampler and the B/L/A phase driver."""
