from sed_jax.models.registry import get_model, MODEL_REGISTRY
