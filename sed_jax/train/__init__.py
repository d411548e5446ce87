from sed_jax.train.state import SedTrainState, create_train_state
from sed_jax.train.step import make_train_step, make_eval_step
