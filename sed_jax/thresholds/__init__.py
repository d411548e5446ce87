from sed_jax.thresholds.optimizer import (
    Adam,
    HyperParamsOptimizer,
    AudioTaggingScoreCalculator,
    SoundEventDetectionScoreCalculator,
)
