from sed_jax.eval.segment_metrics import (
    SegmentBasedMetrics,
    official_evaluate,
    load_event_list_csv,
)
from sed_jax.eval.ap import (
    sed_average_precision,
    clipwise_average_precision,
)
