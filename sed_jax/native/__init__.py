from sed_jax.native.vad_native import (
    native_available,
    decode_packed_tracks,
)
