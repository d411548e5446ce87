"""Train state: params + BN batch stats + AMSGrad optimizer.

The reference optimizes with ``optim.Adam(lr, amsgrad=True)``
(``pytorch/main_strong.py:223-224``); the optax equivalent is
``optax.amsgrad`` with torch-default betas/eps.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import optax


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=['step', 'params', 'batch_stats', 'opt_state'],
                   meta_fields=['tx'])
@dataclasses.dataclass(frozen=True)
class SedTrainState:
    """A pytree of the step count, the variables and the optimizer state;
    ``tx`` (the optax transformation) is static."""

    step: Any
    params: Any
    batch_stats: Any
    opt_state: Any
    tx: optax.GradientTransformation

    @classmethod
    def create(cls, params, tx, batch_stats=None) -> 'SedTrainState':
        return cls(step=0, params=params, batch_stats=batch_stats,
                   opt_state=tx.init(params), tx=tx)

    def replace(self, **changes) -> 'SedTrainState':
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, *, grads) -> 'SedTrainState':
        updates, opt_state = self.tx.update(grads, self.opt_state,
                                            self.params)
        return self.replace(step=self.step + 1,
                            params=optax.apply_updates(self.params, updates),
                            opt_state=opt_state)


def make_optimizer(learning_rate: float = 1e-3) -> optax.GradientTransformation:
    return optax.amsgrad(learning_rate, b1=0.9, b2=0.999, eps=1e-8)


def create_train_state(model, rng, example_input, learning_rate: float = 1e-3,
                       variables: dict | None = None) -> SedTrainState:
    """Initialize (or adopt) variables and build the train state."""
    if variables is None:
        variables = model.init({'params': rng}, example_input, train=False)
    return SedTrainState.create(params=variables['params'],
                                batch_stats=variables.get('batch_stats'),
                                tx=make_optimizer(learning_rate))
