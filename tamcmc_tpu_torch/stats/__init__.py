"""Likelihoods, prior tables and family constraints."""
