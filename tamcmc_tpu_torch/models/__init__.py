"""Model families and the registry of their reference names."""

from tamcmc_tpu_torch.models.registry import (  # noqa: F401
    build_model, list_models)
