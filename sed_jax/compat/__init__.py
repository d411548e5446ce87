from sed_jax.compat.torch_loader import (
    read_torch_pickle,
    state_dict_to_variables,
    load_checkpoint_variables,
)
