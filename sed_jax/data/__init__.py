from sed_jax.data.audio_io import (
    load_audio,
    save_wav,
    resample,
    pad_truncate,
    get_duration,
)
