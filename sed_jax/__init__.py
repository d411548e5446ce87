"""sed_jax — a polyphonic sound event detection framework in JAX.

Built from scratch in JAX/XLA with the full capabilities of the
reference PyTorch system (yazdayy/sound-event-detection): wav -> XML
detection of 25 human + emergency sound classes.

Subpackages
-----------
config      frozen dataclasses: audio-quality triad, labels, SED params
dsp         log-mel / gammatone feature frontends
ops         on-device decoders of the compressed waveform wires
models      model zoo (CNN / GRU / Transformer / Conformer / VGGish) on a
            small in-repo module system with flax.linen's interface
augment     functional PRNG-keyed augmentation (specaugment/mixup/timeshift)
data        HDF5 packing, datasets, samplers, per-host sharded loading
train       jitted train step over a device mesh, checkpointing
post        event decoding (dual-threshold VAD), overlap merge, XML output
eval        segment-based ER/F1 metrics, AP metrics, statistics container
thresholds  per-class threshold optimization (numerical-gradient Adam)
parallel    mesh construction and sharding helpers
compat      PyTorch ``.pth`` checkpoint reader (no torch dependency)
cli         argparse entry points mirroring the reference scripts
"""

__version__ = "0.1.0"
