"""Spectrum model families (MS_Global a1etaa3)."""
