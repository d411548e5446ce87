"""Head-to-head against the ACTUAL reference model code.

The ``test_compat*`` modules prove ``.pth`` round-trips against torch
oracles that were hand-built with the reference's exact state-dict key
names — strong, but still replicas.  This module closes the last gap:
it imports the real ``/root/reference/pytorch/models.py`` (torch CPU,
with a functional ``librosa`` stub whose ``filters.mel`` is the vendored
value oracle from ``test_dsp_frontend``), instantiates the shipped model
classes, saves a genuine reference checkpoint with ``torch.save``, loads
it through ``sed_jax.compat.torch_loader``, and compares FULL forward
outputs — raw waveform in, framewise/clipwise out — so the reference's
own conv-based STFT/logmel frontend (``pytorch/stft.py:157-247,673-734``)
is part of the comparison, not substituted by ours.

Covered classes (reference ``pytorch/models.py``):
  * ``Cnn_9layers_Gru_FrameAtt``        (models.py:564-688, primary)
  * ``Cnn_9layers_Transformer_FrameAtt`` (models.py:981-1077, best ER)
  * ``Cnn_9layers_Conformer_FrameAtt``   (models.py:1189-1376)
plus the T != 1000 roundup/pad quirk (models.py:680-681) on a short clip.
"""

import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from sed_jax.config import AUDIO_16K  # noqa: E402
from sed_jax.compat.torch_loader import load_checkpoint_variables  # noqa: E402
from sed_jax.models.registry import get_model  # noqa: E402

from test_compat import _randomize_bn_stats  # noqa: E402
from test_dsp_frontend import _librosa_mel_oracle  # noqa: E402

REF = '/root/reference'

pytestmark = [pytest.mark.slow, pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, 'pytorch')),
    reason='reference repo not mounted')]


def _functional_librosa_stub():
    """A ``librosa`` stub with the three functions the reference frontend
    classes call at construction time (``pytorch/stft.py:192-195,688``),
    implemented for real: ``filters.mel`` is the vendored librosa value
    oracle, ``filters.get_window`` delegates to scipy (as librosa does
    for string window names), ``util.pad_center`` is librosa's centering
    pad."""
    import scipy.signal

    librosa = types.ModuleType('librosa')
    filters = types.ModuleType('librosa.filters')
    util = types.ModuleType('librosa.util')

    def get_window(window, Nx, fftbins=True):
        return scipy.signal.get_window(window, Nx, fftbins=fftbins)

    def pad_center(data, size, axis=-1):
        n = data.shape[axis]
        lpad = int((size - n) // 2)
        lengths = [(0, 0)] * data.ndim
        lengths[axis] = (lpad, int(size - n - lpad))
        assert lpad >= 0, (size, n)
        return np.pad(data, lengths)

    def mel(sr, n_fft, n_mels=128, fmin=0.0, fmax=None, htk=False,
            norm='slaney', dtype=np.float32):
        return _librosa_mel_oracle(sr, n_fft, n_mels, fmin, fmax,
                                   htk=htk, norm=norm, dtype=dtype)

    def normalize(S, norm=np.inf, axis=0):
        assert norm is None, 'stub supports the norm=None call only'
        return S      # librosa: norm=None returns the input unscaled

    def window_sumsquare(window, n_frames, hop_length=512, win_length=None,
                         n_fft=2048, dtype=np.float32, norm=None):
        # librosa.filters.window_sumsquare (0.9.x): OLA'd squared window
        if win_length is None:
            win_length = n_fft
        n = n_fft + hop_length * (n_frames - 1)
        x = np.zeros(n, dtype=dtype)
        win_sq = normalize(get_window(window, win_length), norm=norm) ** 2
        win_sq = pad_center(win_sq, n_fft)
        for i in range(n_frames):
            sample = i * hop_length
            x[sample:min(n, sample + n_fft)] += \
                win_sq[:max(0, min(n_fft, n - sample))]
        return x

    filters.get_window = get_window
    filters.mel = mel
    filters.window_sumsquare = window_sumsquare
    util.pad_center = pad_center
    util.normalize = normalize
    librosa.filters = filters
    librosa.util = util
    return {'librosa': librosa, 'librosa.filters': filters,
            'librosa.util': util}


@pytest.fixture(scope='module')
def ref_models():
    """Import the ACTUAL reference ``pytorch/models.py`` on CPU torch."""
    stubs = {k: v for k, v in _functional_librosa_stub().items()
             if k not in sys.modules}
    sys.modules.update(stubs)
    paths = [os.path.join(REF, 'pytorch'), os.path.join(REF, 'utils')]
    sys.path[:0] = paths
    try:
        import models as ref_mod
    finally:
        for p in paths:
            sys.path.remove(p)
        for k in stubs:
            sys.modules.pop(k, None)
    return ref_mod


#: deterministic-frontend parameters (frozen in the reference, and
#: recomputed rather than loaded by the rebuild's checkpoint reader)
_FRONTEND_PREFIXES = ('spectrogram_extractor.', 'logmel_extractor.',
                      'stft_extractor.', 'cqt_extractor.',
                      'gamma_extractor.')


def _perturb_parameters(model, rng, scale=0.05):
    """Add noise to every learnable parameter EXCEPT the frozen frontend
    weights (the STFT/mel matrices are deterministic functions of the
    audio config — the rebuild recomputes them, so perturbing the
    reference's copies would compare against a corrupted frontend).
    Buffers are also left alone: the reference stores e.g.
    positional-encoding tables as buffers that the rebuild recomputes.
    Defaults like LayerNorm weight=1/bias=0 would otherwise mask
    transposition/mapping bugs."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith(_FRONTEND_PREFIXES):
                continue
            p.add_(torch.from_numpy(
                rng.uniform(-scale, scale, p.shape).astype(np.float32)))


def _head_to_head(ref_model, model_type, wav, tmp_path, tol=5e-4):
    """torch.save the ACTUAL reference model -> pure-python load ->
    flax forward on raw waveform -> compare output dicts."""
    ref_model = ref_model.eval()
    with torch.no_grad():
        want = ref_model(torch.from_numpy(wav))
    path = str(tmp_path / 'ref_ckpt.pth')
    torch.save({'iteration': 41, 'model': ref_model.state_dict()}, path)
    variables, it = load_checkpoint_variables(path)
    assert it == 41

    model = get_model(model_type, AUDIO_16K)
    out = model.apply(variables, jnp.asarray(wav), train=False)

    got_clip = np.asarray(out['clipwise_output'])
    got_frame = np.asarray(out['framewise_output'])
    want_clip = want['clipwise_output'].numpy()
    want_frame = want['framewise_output'].numpy()
    assert got_frame.shape == want_frame.shape
    np.testing.assert_allclose(got_clip, want_clip, rtol=1e-3, atol=tol)
    np.testing.assert_allclose(got_frame, want_frame, rtol=1e-3, atol=tol)


def test_gru_frameatt_vs_actual_reference(ref_models, tmp_path):
    """Full 10 s clip: reference frontend emits 1001 frames -> 125 after
    pooling -> x8 interpolate = 1000 (the pad branch is NOT taken)."""
    torch.manual_seed(10)
    rng = np.random.RandomState(10)
    m = ref_models.Cnn_9layers_Gru_FrameAtt(
        16000, 512, 160, 64, 25, 7000, 25, 'logmel')
    _perturb_parameters(m, rng)
    _randomize_bn_stats(m, rng)
    wav = rng.uniform(-0.5, 0.5, (2, 160000)).astype(np.float32)
    _head_to_head(m, 'Cnn_9layers_Gru_FrameAtt', wav, tmp_path)


def test_gru_frameatt_short_clip_pad_quirk(ref_models, tmp_path):
    """3 s clip: 301 frames -> 37 -> x8 = 296 != 1000, so the reference
    pads to roundup(296)=300 by repeating the last frame
    (models.py:680-681) — the rebuild must reproduce that exactly."""
    torch.manual_seed(11)
    rng = np.random.RandomState(11)
    m = ref_models.Cnn_9layers_Gru_FrameAtt(
        16000, 512, 160, 64, 25, 7000, 25, 'logmel')
    _perturb_parameters(m, rng)
    _randomize_bn_stats(m, rng)
    wav = rng.uniform(-0.5, 0.5, (1, 48000)).astype(np.float32)
    _head_to_head(m, 'Cnn_9layers_Gru_FrameAtt', wav, tmp_path)


def test_transformer_frameatt_vs_actual_reference(ref_models, tmp_path):
    torch.manual_seed(12)
    rng = np.random.RandomState(12)
    m = ref_models.Cnn_9layers_Transformer_FrameAtt(
        16000, 512, 160, 64, 25, 7000, 25, 'logmel')
    _perturb_parameters(m, rng)
    _randomize_bn_stats(m, rng)
    wav = rng.uniform(-0.5, 0.5, (2, 80000)).astype(np.float32)
    _head_to_head(m, 'Cnn_9layers_Transformer_FrameAtt', wav, tmp_path)


def test_conformer_frameatt_vs_actual_reference(ref_models, tmp_path):
    """main_strong passes ``feature_type`` as the conformer's
    ``cnn_kwargs`` positional (main_strong.py:204 vs models.py:1194) —
    an ignored-arg quirk; the constructor overwrites cnn_kwargs."""
    torch.manual_seed(13)
    rng = np.random.RandomState(13)
    m = ref_models.Cnn_9layers_Conformer_FrameAtt(
        16000, 512, 160, 64, 25, 7000, 25, 'logmel')
    _perturb_parameters(m, rng)
    _randomize_bn_stats(m, rng)
    wav = rng.uniform(-0.5, 0.5, (1, 80000)).astype(np.float32)
    _head_to_head(m, 'Cnn_9layers_Conformer_FrameAtt', wav, tmp_path)


# ---------------------------------------------------------------------------
# The rest of the zoo, each against the ACTUAL reference class.  Short
# clips keep the 1-vCPU cost down AND exercise the interpolate/pad tails
# at T != 1000.
# ---------------------------------------------------------------------------

def _build_and_compare(ref_models, cls_name, args, model_type, seconds,
                       tmp_path, seed, batch=1, tol=5e-4):
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    m = getattr(ref_models, cls_name)(*args)
    _perturb_parameters(m, rng)
    _randomize_bn_stats(m, rng)
    wav = rng.uniform(-0.5, 0.5,
                      (batch, int(16000 * seconds))).astype(np.float32)
    _head_to_head(m, model_type, wav, tmp_path, tol=tol)


_STD = (16000, 512, 160, 64, 25, 7000, 25)


def test_frame_max_vs_actual_reference(ref_models, tmp_path):
    _build_and_compare(ref_models, 'Cnn_9layers_FrameMax', _STD,
                       'Cnn_9layers_FrameMax', 5, tmp_path, 20)


def test_frame_avg_vs_actual_reference(ref_models, tmp_path):
    _build_and_compare(ref_models, 'Cnn_9layers_FrameAvg', _STD,
                       'Cnn_9layers_FrameAvg', 2.5, tmp_path, 21)


def test_frame_att_vs_actual_reference(ref_models, tmp_path):
    _build_and_compare(ref_models, 'Cnn_9layers_FrameAtt', _STD,
                       'Cnn_9layers_FrameAtt', 2.5, tmp_path, 22)


def test_gru_frameavg_vs_actual_reference(ref_models, tmp_path):
    _build_and_compare(ref_models, 'Cnn_9layers_Gru_FrameAvg',
                       _STD + ('logmel',),
                       'Cnn_9layers_Gru_FrameAvg', 2.5, tmp_path, 23)


def test_gru_reg_no_pad_quirk_vs_actual_reference(ref_models, tmp_path):
    """Gru_Reg's pad_framewise_output is commented out upstream
    (models.py:2883) so a 3 s clip yields T=296, NOT the FrameAtt's
    padded 300 — the rebuild must reproduce the shape difference."""
    _build_and_compare(ref_models, 'Cnn_9layers_Gru_Reg',
                       _STD + ('logmel',),
                       'Cnn_9layers_Gru_Reg', 3, tmp_path, 24)


def test_gru_14layers_vs_actual_reference(ref_models, tmp_path):
    _build_and_compare(ref_models, 'Cnn_14layers_Gru_FrameAtt',
                       _STD + ('logmel',),
                       'Cnn_14layers_Gru_FrameAtt', 2.5, tmp_path, 25)


def test_transformer_frameavg_vs_actual_reference(ref_models, tmp_path):
    _build_and_compare(ref_models, 'Cnn_9layers_Transformer_FrameAvg',
                       _STD + ('logmel',),
                       'Cnn_9layers_Transformer_FrameAvg', 2.5, tmp_path, 26)


def test_transformer_14layers_vs_actual_reference(ref_models, tmp_path):
    _build_and_compare(ref_models, 'Cnn_14layers_Transformer_FrameAtt',
                       _STD + ('logmel',),
                       'Cnn_14layers_Transformer_FrameAtt', 2.5, tmp_path, 27)


def test_conformer_frameavg_vs_actual_reference(ref_models, tmp_path):
    _build_and_compare(ref_models, 'Cnn_9layers_Conformer_FrameAvg',
                       _STD + ('logmel',),
                       'Cnn_9layers_Conformer_FrameAvg', 2.5, tmp_path, 28)


def test_conformer_14layers_vs_actual_reference(ref_models, tmp_path):
    _build_and_compare(ref_models, 'Cnn_14layers_Conformer_FrameAtt',
                       _STD + ('logmel',),
                       'Cnn_14layers_Conformer_FrameAtt', 2.5, tmp_path, 29)


def test_cnn14_decision_level_att_vs_actual_reference(ref_models, tmp_path):
    _build_and_compare(ref_models, 'Cnn14_DecisionLevelAtt', _STD,
                       'Cnn14_DecisionLevelAtt', 2.5, tmp_path, 30)


def test_token_pooling_9layers_vs_actual_reference(ref_models, tmp_path,
                                                   monkeypatch):
    """Cnn_9layers_Conformer flattens time x freq into the token
    sequence (models.py:2156) and ships framewise logits WITHOUT
    interpolation (models.py:2204, commented out) — 5 s in, 496 frame
    tokens out.  The forward also hard-codes ``.cuda()`` on the learned
    tag token (models.py:2163); identity-patch Tensor.cuda so the
    ACTUAL code runs on CPU."""
    monkeypatch.setattr(torch.Tensor, 'cuda',
                        lambda self, *a, **k: self, raising=True)
    _build_and_compare(ref_models, 'Cnn_9layers_Conformer', _STD,
                       'Cnn_9layers_Conformer', 5, tmp_path, 31)


def test_token_pooling_7layers_vs_actual_reference(ref_models, tmp_path,
                                                   monkeypatch):
    """Cnn_7layers_Conformer.forward is DEAD CODE upstream: it passes
    ``spec_augment=`` to its own preprocess (models.py:1960) whose
    signature lacks that kwarg (models.py:1934) — every call raises
    TypeError, like RegBlock.  Pin the breakage, then compare the
    rebuild against the intended semantics by patching preprocess to
    accept-and-ignore the kwarg (its spec-augment use is commented out
    upstream anyway, models.py:1944-1945)."""
    monkeypatch.setattr(torch.Tensor, 'cuda',
                        lambda self, *a, **k: self, raising=True)
    torch.manual_seed(31)
    rng = np.random.RandomState(31)
    m = ref_models.Cnn_7layers_Conformer(*_STD)
    _perturb_parameters(m, rng)
    _randomize_bn_stats(m, rng)
    wav = rng.uniform(-0.5, 0.5, (1, 80000)).astype(np.float32)
    with pytest.raises(TypeError):
        with torch.no_grad():
            m.eval()(torch.from_numpy(wav))
    orig = m.preprocess
    m.preprocess = (lambda x, mixup_lambda=None, timeshift=False,
                    spec_augment=True:
                    orig(x, mixup_lambda=mixup_lambda, timeshift=timeshift))
    _head_to_head(m, 'Cnn_7layers_Conformer', wav, tmp_path)


@pytest.mark.parametrize('cls_name,head_secs',
                         [('VGGish_FrameAtt', 10),
                          ('VGGish_Gru_FrameAtt', 10),
                          ('VGGish_FrameAvg', 10)])
def test_vggish_family_vs_actual_reference(ref_models, tmp_path, cls_name,
                                           head_secs):
    """The VGGish heads load a backbone checkpoint at construction
    (models.py:2329-2336) and strip its fc stack, leaving the
    ``vggish.0.N`` key layout; fabricate that artifact from the ACTUAL
    reference VGGish class."""
    torch.manual_seed(32)
    rng = np.random.RandomState(32)
    backbone = ref_models.VGGish()
    vggish_path = str(tmp_path / 'pytorch_vggish.pth')
    torch.save(backbone.state_dict(), vggish_path)
    m = getattr(ref_models, cls_name)(*(_STD + ('logmel', vggish_path)))
    _perturb_parameters(m, rng)
    _randomize_bn_stats(m, rng)
    wav = rng.uniform(-0.5, 0.5,
                      (1, int(16000 * head_secs))).astype(np.float32)
    _head_to_head(m, cls_name, wav, tmp_path)


# ---------------------------------------------------------------------------
# DSP transform classes, head-to-head with the ACTUAL pytorch/stft.py
# (the reference's own de-facto test harness is its stft.py debug();
# here the real torch modules themselves are the oracle).
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def ref_stft(ref_models):
    """pytorch/stft.py, already imported (with the functional librosa
    stub bound into its globals) as a side effect of importing models."""
    return sys.modules['stft']


def test_dft_vs_actual_reference(ref_stft):
    """DFT/IDFT/RDFT/IRDFT (stft.py:34-154) vs dsp/transforms.

    Two upstream quirks pinned here: (a) norm=None idft divides only
    the REAL part by n (stft.py:93-94) — the rebuild deliberately
    scales both so idft(dft(x)) == x (documented in transforms.idft);
    (b) the norm='ortho' inverse branches reference an undefined bare
    ``n`` (stft.py:96-97,151) and raise NameError on every call —
    dead code upstream."""
    from sed_jax.dsp import transforms
    rng = np.random.RandomState(40)
    n = 64
    xr = rng.randn(n).astype(np.float32)
    xi = rng.randn(n).astype(np.float32)

    ref = ref_stft.DFT(n, None)
    with torch.no_grad():
        zr, zi = ref.dft(torch.from_numpy(xr), torch.from_numpy(xi))
        wr, wi = ref.idft(torch.from_numpy(xr), torch.from_numpy(xi))
        rr, ri = ref.rdft(torch.from_numpy(xr))
        br = ref.irdft(torch.from_numpy(rr.numpy()),
                       torch.from_numpy(ri.numpy()))
    gr, gi = transforms.dft(jnp.asarray(xr), jnp.asarray(xi), None)
    np.testing.assert_allclose(np.asarray(gr), zr.numpy(), atol=1e-3)
    np.testing.assert_allclose(np.asarray(gi), zi.numpy(), atol=1e-3)
    gr, gi = transforms.idft(jnp.asarray(xr), jnp.asarray(xi), None)
    np.testing.assert_allclose(np.asarray(gr), wr.numpy(), atol=1e-3)
    # quirk (a): reference imag is unscaled; ours is imag / n
    np.testing.assert_allclose(np.asarray(gi) * n, wi.numpy(), atol=1e-3)
    gr, gi = transforms.rdft(jnp.asarray(xr), None)
    np.testing.assert_allclose(np.asarray(gr), rr.numpy(), atol=1e-3)
    np.testing.assert_allclose(np.asarray(gi), ri.numpy(), atol=1e-3)
    gb = transforms.irdft(jnp.asarray(rr.numpy()),
                          jnp.asarray(ri.numpy()), None)
    np.testing.assert_allclose(np.asarray(gb), br.numpy(), atol=1e-3)
    # irdft(rdft(x)) must reconstruct the signal in both systems
    np.testing.assert_allclose(np.asarray(gb), xr, atol=1e-3)

    # 'ortho' forward transforms agree; inverse is dead code upstream
    ref_o = ref_stft.DFT(n, 'ortho')
    with torch.no_grad():
        zr, zi = ref_o.dft(torch.from_numpy(xr), torch.from_numpy(xi))
        rr, ri = ref_o.rdft(torch.from_numpy(xr))
    gr, gi = transforms.dft(jnp.asarray(xr), jnp.asarray(xi), 'ortho')
    np.testing.assert_allclose(np.asarray(gr), zr.numpy(), atol=1e-3)
    np.testing.assert_allclose(np.asarray(gi), zi.numpy(), atol=1e-3)
    gr, gi = transforms.rdft(jnp.asarray(xr), 'ortho')
    np.testing.assert_allclose(np.asarray(gr), rr.numpy(), atol=1e-3)
    np.testing.assert_allclose(np.asarray(gi), ri.numpy(), atol=1e-3)
    with pytest.raises(NameError):
        ref_o.idft(torch.from_numpy(xr), torch.from_numpy(xi))
    with pytest.raises(NameError):
        ref_o.irdft(torch.from_numpy(rr.numpy()),
                    torch.from_numpy(ri.numpy()))
    # the rebuild's ortho inverse is a working round trip
    ir, ii = transforms.idft(
        *transforms.dft(jnp.asarray(xr), jnp.asarray(xi), 'ortho'),
        'ortho')
    np.testing.assert_allclose(np.asarray(ir), xr, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ii), xi, atol=1e-3)


def test_stft_istft_vs_actual_reference(ref_stft):
    """STFT (stft.py:157-247) and ISTFT (stft.py:269-633) vs the MXU
    matmul stft and the overlap-add istft, plus round-trip fidelity."""
    from sed_jax.dsp import filters as our_filters
    from sed_jax.dsp import frontend, transforms
    rng = np.random.RandomState(41)
    n_fft, hop, length = 512, 160, 16000
    x = rng.uniform(-0.5, 0.5, (2, length)).astype(np.float32)

    ref = ref_stft.STFT(n_fft=n_fft, hop_length=hop, win_length=n_fft,
                        window='hann', center=True, pad_mode='reflect')
    with torch.no_grad():
        want_re, want_im = ref(torch.from_numpy(x))   # (B, 1, T, bins)
    mat = our_filters.stft_matrices(n_fft, n_fft, 'hann')
    got_re, got_im = frontend.stft(jnp.asarray(x), jnp.asarray(mat), hop)
    np.testing.assert_allclose(np.asarray(got_re),
                               want_re[:, 0].numpy(), atol=1e-3)
    np.testing.assert_allclose(np.asarray(got_im),
                               want_im[:, 0].numpy(), atol=1e-3)

    inv = ref_stft.ISTFT(n_fft=n_fft, hop_length=hop, win_length=n_fft,
                         window='hann', center=True, pad_mode='reflect')
    with torch.no_grad():
        want_x = inv(want_re, want_im, length).numpy()
    got_x = np.asarray(transforms.istft(got_re, got_im, n_fft, hop,
                                        length=length))
    np.testing.assert_allclose(got_x, want_x, atol=1e-4)
    np.testing.assert_allclose(got_x, x, atol=1e-4)   # round trip


def test_enframe_and_magphase_vs_actual_reference(ref_stft):
    from sed_jax.dsp import transforms
    rng = np.random.RandomState(42)
    x = rng.uniform(-0.5, 0.5, (2, 8000)).astype(np.float32)
    ref = ref_stft.Enframe(frame_length=1024, hop_length=320)
    with torch.no_grad():
        want = ref(torch.from_numpy(x)).numpy()   # (B, frame_len, T)
    got = np.asarray(transforms.enframe(jnp.asarray(x), 1024, 320))
    np.testing.assert_allclose(got, want, atol=1e-6)

    re = rng.randn(3, 7).astype(np.float32)
    im = rng.randn(3, 7).astype(np.float32)
    with torch.no_grad():
        wm, wc, ws = ref_stft.magphase(torch.from_numpy(re),
                                       torch.from_numpy(im))
    gm, gc, gs = transforms.magphase(jnp.asarray(re), jnp.asarray(im))
    np.testing.assert_allclose(np.asarray(gm), wm.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gc), wc.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(gs), ws.numpy(), atol=1e-5)
