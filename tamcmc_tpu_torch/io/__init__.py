"""Sample writers (.bin/.hdr, byte-compatible with tamcmc_tpu)."""
