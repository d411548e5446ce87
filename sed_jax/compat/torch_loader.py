"""PyTorch ``.pth`` checkpoint reader — no torch dependency.

The reference saves ``{'iteration', 'model': model.module.state_dict(),
'optimizer': ...}`` via ``torch.save`` (``pytorch/main_strong.py:326-334``).
torch's new-style format is a zip archive holding ``data.pkl`` (a pickle
whose tensors are persistent-id references) plus one raw little-endian
buffer per storage under ``data/``.  This module unpickles that format
with a custom Unpickler, rebuilds tensors as numpy arrays (honoring
size/stride/offset), and maps the reference's state-dict keys onto
sed_jax variable trees.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from typing import Any, Dict, Tuple

import numpy as np

_DTYPE_BY_STORAGE = {
    'FloatStorage': np.float32,
    'DoubleStorage': np.float64,
    'HalfStorage': np.float16,
    'LongStorage': np.int64,
    'IntStorage': np.int32,
    'ShortStorage': np.int16,
    'CharStorage': np.int8,
    'ByteStorage': np.uint8,
    'BoolStorage': np.bool_,
    'BFloat16Storage': None,  # handled specially
}


class _AttrDict(dict):
    """dict subclass standing in for OrderedDict: torch pickles attach a
    ``_metadata`` attribute via the BUILD opcode, which plain dict rejects."""


class _StorageRef:
    def __init__(self, storage_type: str, key: str, numel: int):
        self.storage_type = storage_type
        self.key = key
        self.numel = numel


class _FakeTensorReconstructor:
    """Stand-in for torch._utils._rebuild_tensor_v2 and friends."""

    def __init__(self, name):
        self.name = name

    def __call__(self, *args):
        if self.name in ('_rebuild_tensor_v2', '_rebuild_tensor'):
            storage, offset, size, stride = args[0], args[1], args[2], args[3]
            return _materialize(storage, offset, size, stride)
        if self.name == '_rebuild_parameter':
            return args[0]
        raise pickle.UnpicklingError(f'unsupported reconstructor {self.name}')


def _materialize(ref, offset, size, stride):
    arr, dtype = ref  # set by persistent_load resolution
    flat = arr
    if not size:
        return flat[offset].copy()
    out = np.lib.stride_tricks.as_strided(
        flat[offset:], shape=tuple(size),
        strides=tuple(s * flat.itemsize for s in stride))
    return np.ascontiguousarray(out)


class _TorchUnpickler(pickle.Unpickler):
    def __init__(self, file, storages):
        super().__init__(file)
        self._storages = storages

    def find_class(self, module: str, name: str):
        if module == 'torch._utils':
            return _FakeTensorReconstructor(name)
        if module == 'torch' and name.endswith('Storage'):
            return name  # storage type tag, consumed by persistent_load
        if module == 'collections' and name == 'OrderedDict':
            return _AttrDict
        if module == 'numpy.core.multiarray' and name == '_reconstruct':
            return np.core.multiarray._reconstruct
        if module == 'numpy' and name in ('ndarray', 'dtype'):
            return getattr(np, name)
        if module == 'torch' and name in ('float32', 'float64', 'float16',
                                          'int64', 'int32', 'bfloat16'):
            return name
        raise pickle.UnpicklingError(
            f'blocked unpickle of {module}.{name}')

    def persistent_load(self, pid):
        # pid = ('storage', storage_type, key, location, numel)
        assert pid[0] == 'storage'
        storage_type, key, _location, numel = pid[1], pid[2], pid[3], pid[4]
        if not isinstance(storage_type, str):
            storage_type = getattr(storage_type, '__name__', str(storage_type))
        raw = self._storages[key]
        if storage_type == 'BFloat16Storage':
            u16 = np.frombuffer(raw, dtype=np.uint16, count=numel)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            dtype = _DTYPE_BY_STORAGE[storage_type]
            arr = np.frombuffer(raw, dtype=dtype, count=numel)
        return (arr, arr.dtype)


def read_torch_pickle(path: str) -> Any:
    """Read a ``torch.save``d object (new zip format) as numpy arrays."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl_name = next(n for n in names if n.endswith('/data.pkl')
                        or n == 'data.pkl')
        prefix = pkl_name[:-len('data.pkl')]
        storages = {}
        for n in names:
            if n.startswith(prefix + 'data/'):
                storages[n[len(prefix + 'data/'):]] = zf.read(n)
        data = zf.read(pkl_name)
    return _TorchUnpickler(io.BytesIO(data), storages).load()


# ---------------------------------------------------------------------------
# state_dict -> model variables
# ---------------------------------------------------------------------------

# torch keys that carry no information for the rebuilt models: the frozen
# DSP frontend weights (recomputed here), vestigial blocks never used in
# the reference forward, and BN bookkeeping.
_SKIP_SUBSTRINGS = (
    'spectrogram_extractor.', 'logmel_extractor.', 'stft_extractor.',
    'gamma_extractor.', 'cqt_extractor.',
    'att_block.bn_att.', 'multihead.layer_norm.',
    'num_batches_tracked',
)

# registered buffers recomputed at trace time here: sinusoidal positional
# tables (``transformer/embedding.py:20-31``) and the rel-attention
# inverse-frequency table (``conformer/attention.py:125-133``)
_BUFFER_LEAVES = ('pe', 'inv_freq')


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


# ---------------------------------------------------------------------------
# encoder-package key mapping (DCASE-2020 Conformer / ESPnet Transformer,
# ``pytorch/models_2020/``) and DCASE baseline CNN (``baseline_model.py``)
# ---------------------------------------------------------------------------

# ffn Sequential indices (``conformer/macaron_feed_forward.py:9-16``)
_FFN_SUBMAP = {'0': ('norm', 'ln'), '1': ('w_1', 'linear'),
               '4': ('w_2', 'linear')}
# ConvolutionModule Sequential indices (``conformer/convolution.py:38-51``)
_CONVMOD_SUBMAP = {'0': ('norm', 'ln'), '1': ('pw1', 'pw'),
                   '3': ('dw', 'dw'), '5': ('bn', 'bn'),
                   '8': ('pw2', 'pw')}


def _encoder_owner(owner: Tuple[str, ...]):
    """Reference ``encoder.*`` owner path -> (sed_jax path, weight kind).

    Covers the ConformerEncoder (``conformer_encoder.py:21-28``: Sequential
    input layer; ``conformer_block.py:9-14``: ffn1/mhsa/conv/ffn2/norm) and
    the ESPnet TransformerEncoder (``transformer/encoder.py:34-71``).
    """
    rest = owner[1:]
    if rest == ('norm',):                          # final encoder LN
        return ('encoder', 'norm'), 'ln'
    if rest and rest[0] == 'input_layer':
        sub = rest[1:]
        if sub == ('0',):
            return ('encoder', 'input_layer', 'linear'), 'linear'
        if sub == ('1',):
            return ('encoder', 'input_layer', 'norm'), 'ln'
        if sub == ('conv', '0'):
            return ('encoder', 'input_layer', 'conv1'), 'conv2d'
        if sub == ('conv', '2'):
            return ('encoder', 'input_layer', 'conv2'), 'conv2d'
        if sub == ('out', '0'):
            return ('encoder', 'input_layer', 'out'), 'linear'
        raise KeyError(f'unmapped encoder input_layer key: {owner}')
    if rest and rest[0] == 'conformer_blocks':
        ours = ('encoder', f'block{rest[1]}')
        sub = rest[2:]
        if sub and sub[0] in ('ffn1', 'ffn2'):
            name, kind = _FFN_SUBMAP[sub[2]]       # sub[1]='feed_forward_module'
            return ours + (sub[0], name), kind
        if sub and sub[0] == 'mhsa':
            if sub[1] == 'layer_norm':
                return ours + ('mhsa', 'layer_norm'), 'ln'
            if sub[1] in ('qkv_net', 'o_net', 'r_net'):
                return ours + ('mhsa', sub[1]), 'linear'
            raise KeyError(f'unmapped mhsa key: {owner}')
        if sub and sub[0] == 'conv':
            name, kind = _CONVMOD_SUBMAP[sub[2]]   # sub[1]='conv'
            return ours + ('conv', name), kind
        if sub == ('norm',):
            return ours + ('norm',), 'ln'
        raise KeyError(f'unmapped conformer block key: {owner}')
    if rest and rest[0] == 'encoders':             # ESPnet encoder layers
        ours = ('encoder', f'layer{rest[1]}')
        sub = rest[2:]
        if sub and sub[0] == 'self_attn':
            return ours + ('self_attn', sub[1]), 'linear'
        if sub and sub[0] == 'feed_forward':
            return ours + ('feed_forward', sub[1]), 'linear'
        if sub in (('norm1',), ('norm2',)):
            return ours + sub, 'ln'
        raise KeyError(f'unmapped transformer layer key: {owner}')
    raise KeyError(f'unmapped encoder key: {owner}')


def _baseline_cnn_owner(owner: Tuple[str, ...]):
    """``cnn.cnn.*`` (DCASE baseline CNN Sequential,
    ``baseline_model.py:50-74``) -> sed_jax BaselineCNN path."""
    name = owner[2]
    if name.startswith('conv'):
        return ('cnn', name), 'conv2d'
    if name.startswith('batchnorm'):
        return ('cnn', 'bn' + name[len('batchnorm'):]), 'bn'
    if name.startswith(('glu', 'cg')):             # inner .linear
        return ('cnn', name, 'linear'), 'linear'
    raise KeyError(f'unmapped baseline CNN key: {owner}')


def _assign(kind: str, ours: Tuple[str, ...], leaf: str, val: np.ndarray,
            params: dict, batch_stats: dict, key: str):
    """Place one torch tensor into the variable trees by weight kind."""
    if kind == 'ln':
        _set(params, (*ours, 'scale' if leaf == 'weight' else 'bias'), val)
    elif kind == 'linear':
        _set(params, (*ours, 'kernel' if leaf == 'weight' else 'bias'),
             val.T if leaf == 'weight' else val)
    elif kind == 'conv2d':                         # OIHW -> HWIO
        _set(params, (*ours, 'kernel' if leaf == 'weight' else 'bias'),
             val.transpose(2, 3, 1, 0) if leaf == 'weight' else val)
    elif kind == 'pw':                             # Conv1d 1x1 -> Dense
        _set(params, (*ours, 'kernel' if leaf == 'weight' else 'bias'),
             val[:, :, 0].T if leaf == 'weight' else val)
    elif kind == 'dw':                             # (C,1,K) -> (K,1,C)
        _set(params, (*ours, 'kernel' if leaf == 'weight' else 'bias'),
             val.transpose(2, 1, 0) if leaf == 'weight' else val)
    elif kind == 'bn':
        if leaf == 'weight':
            _set(params, (*ours, 'scale'), val)
        elif leaf == 'bias':
            _set(params, (*ours, 'bias'), val)
        elif leaf == 'running_mean':
            _set(batch_stats, (*ours, 'mean'), val)
        elif leaf == 'running_var':
            _set(batch_stats, (*ours, 'var'), val)
        else:
            raise KeyError(f'unhandled BN key {key}')
    else:
        raise KeyError(f'unknown weight kind {kind} for {key}')


def state_dict_to_variables(state_dict: Dict[str, np.ndarray]) -> dict:
    """Map a reference model state_dict onto sed_jax model variables.

    Handles: bn0 / conv blocks / GRU / AttBlock (1x1 conv1d -> Dense) /
    MultiHead + fc linears.  Unknown keys raise so silent drift is
    impossible.
    """
    params: dict = {}
    batch_stats: dict = {}

    for key, val in state_dict.items():
        if key.startswith('module.'):
            key = key[len('module.'):]
        if any(s in key for s in _SKIP_SUBSTRINGS):
            continue
        parts = key.split('.')
        leaf = parts[-1]
        owner = parts[:-1]
        oname = '.'.join(owner)

        if leaf in _BUFFER_LEAVES:         # recomputed positional tables
            continue

        # --- DCASE-2020 encoder package (Conformer / ESPnet Transformer)
        if parts[0] == 'encoder':
            if leaf in ('r_w_bias', 'r_r_bias'):
                # encoder.conformer_blocks.{i}.mhsa.r_{w,r}_bias,
                # (n_head, d_head) params stored verbatim
                _set(params, ('encoder', f'block{parts[2]}', 'mhsa', leaf),
                     val)
                continue
            ours, kind = _encoder_owner(tuple(owner))
            _assign(kind, ours, leaf, val, params, batch_stats, key)
            continue

        # --- DCASE baseline CNN (``cnn.cnn.*``) ----------------------------
        if len(parts) >= 3 and parts[0] == 'cnn' and parts[1] == 'cnn':
            ours, kind = _baseline_cnn_owner(tuple(owner))
            _assign(kind, ours, leaf, val, params, batch_stats, key)
            continue

        # --- BatchNorm (bn0, conv_blockN.bn{1,2}) -------------------------
        if parts[-2].startswith('bn') or parts[-2] == 'bn0':
            if leaf == 'weight':
                _set(params, (*owner, 'scale'), val)
            elif leaf == 'bias':
                _set(params, (*owner, 'bias'), val)
            elif leaf == 'running_mean':
                _set(batch_stats, (*owner, 'mean'), val)
            elif leaf == 'running_var':
                _set(batch_stats, (*owner, 'var'), val)
            else:
                raise KeyError(f'unhandled BN key {key}')
            continue

        # --- VGGish Sequential indices -> conv{i}
        # (torch keys vggish.features.{0,3,6,8,11,13}.*, models.py:2230-2250)
        if 'vggish' in parts and parts[-2].isdigit():
            seq_to_conv = {0: 'conv0', 3: 'conv1', 6: 'conv2', 8: 'conv3',
                           11: 'conv4', 13: 'conv5'}
            conv_name = seq_to_conv.get(int(parts[-2]))
            if conv_name is None:
                continue  # fc stack is stripped by the reference too
            if leaf == 'weight':
                _set(params, ('vggish', conv_name, 'kernel'),
                     val.transpose(2, 3, 1, 0))
            else:
                _set(params, ('vggish', conv_name, 'bias'), val)
            continue

        # --- conv layers (OIHW -> HWIO) -----------------------------------
        if parts[-2].startswith('conv') and leaf == 'weight' and val.ndim == 4:
            _set(params, (*owner, 'kernel'), val.transpose(2, 3, 1, 0))
            continue

        # --- GRU ----------------------------------------------------------
        if parts[-2] == 'gru' or (len(parts) >= 2 and parts[0] == 'gru'):
            direction = 'bw' if leaf.endswith('_reverse') else 'fw'
            base = leaf.replace('_reverse', '')
            name = {'weight_ih_l0': 'w_ih', 'weight_hh_l0': 'w_hh',
                    'bias_ih_l0': 'b_ih', 'bias_hh_l0': 'b_hh'}[base]
            _set(params, ('gru', direction, name), val)
            continue

        # --- AttBlock 1x1 conv1d (O, I, 1) -> Dense kernel (I, O) ---------
        if 'att_block' in oname and val.ndim == 3:
            _set(params, (*owner, 'kernel'), val[:, :, 0].T)
            continue
        if 'att_block' in oname and leaf == 'bias':
            _set(params, (*owner, 'bias'), val)
            continue

        # --- Linear layers (out, in) -> kernel (in, out) -------------------
        if leaf == 'weight' and val.ndim == 2:
            _set(params, (*owner, 'kernel'), val.T)
            continue
        if leaf == 'bias' and val.ndim == 1:
            _set(params, (*owner, 'bias'), val)
            continue

        raise KeyError(f'unmapped reference checkpoint key: {key}')

    out = {'params': params}
    if batch_stats:
        out['batch_stats'] = batch_stats
    return out


def load_checkpoint_variables(path: str) -> Tuple[dict, int]:
    """Load a reference training checkpoint -> (variables, iteration).

    The checkpoint layout is ``{'iteration', 'model', 'optimizer'}``
    (``pytorch/main_strong.py:326-334``); bare state_dicts also work.
    """
    obj = read_torch_pickle(path)
    if isinstance(obj, dict) and 'model' in obj:
        state_dict = obj['model']
        iteration = int(obj.get('iteration', 0))
    else:
        state_dict = obj
        iteration = 0
    return state_dict_to_variables(state_dict), iteration
