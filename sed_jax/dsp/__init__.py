from sed_jax.dsp.filters import (
    periodic_hann,
    stft_matrices,
    mel_filterbank,
)
from sed_jax.dsp.frontend import (
    LogmelFrontend,
    frame_signal,
    stft,
    spectrogram,
    power_to_db,
)
