"""Numpy-only helpers shared with the reference package."""
