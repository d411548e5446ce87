from sed_jax.utils.paths import Workspace
from sed_jax.utils.statistics import StatisticsContainer
from sed_jax.utils.logging_utils import create_logging, get_filename
