from sed_jax.augment.functional import (
    spec_augment,
    do_mixup,
    do_timeshift,
    do_mixup_timeshift,
    mixup_lambda,
    MixupGenerator,
)
