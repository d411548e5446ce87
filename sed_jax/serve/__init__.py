from sed_jax.serve.engine import SedInferenceEngine, window_starts
