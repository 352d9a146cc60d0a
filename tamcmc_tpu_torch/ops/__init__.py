"""Lorentzian profiles (plain torch + CUDA kernels), noise, rotation, visibilities."""
