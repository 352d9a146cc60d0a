"""PyTorch + CUDA port of tamcmc_tpu: the MS_Global a1etaa3 peak-bagging fit
with the windowed Lorentzian sum as hand-written Hopper kernels.

The JAX package `tamcmc_tpu` is the reference this package is held against;
nothing here imports it (or JAX)."""
