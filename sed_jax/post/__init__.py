from sed_jax.post.vad import activity_detection, activity_detection_binary
from sed_jax.post.events import (
    frame_prediction_to_event_prediction,
    frame_prediction_to_event_prediction_v2,
    frame_binary_prediction_to_event_prediction,
    write_submission,
)
from sed_jax.post.merge import overlap_add_windows
from sed_jax.post.xml_writer import events_to_xml
