"""Entry points: the compile cache location, the GPU smoke script's
refusal on the CPU, and the main path without optional packages.

Each case runs in a fresh interpreter, so that what it sets or blocks
cannot leak into the other tests.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env_update: dict, *args: str, timeout: int = 240):
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    env.update(JAX_PLATFORMS='cpu', PYTHONPATH=REPO, **env_update)
    return subprocess.run(
        [sys.executable, '-c', textwrap.dedent(code), *args], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=timeout)


_CACHE_PROBE = """
    import os, sys, jax, jax.numpy as jnp
    from sed_jax.utils import compile_cache
    path = compile_cache.enable()
    if sys.argv[1:] == ['compile']:
        jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)
        jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.arange(7.0)).block_until_ready()
    print(path)
    print(jax.config.jax_compilation_cache_dir)
    print(len(os.listdir(path)) if os.path.isdir(path) else 0)
"""


def test_compile_cache_honours_env_var(tmp_path):
    cache = str(tmp_path / 'cache')
    proc = _run(_CACHE_PROBE, {'JAX_COMPILATION_CACHE_DIR': cache},
                'compile')
    assert proc.returncode == 0, proc.stderr
    path, configured, entries = proc.stdout.split()
    assert path == configured == cache
    assert int(entries) > 0


def test_compile_cache_falls_back_to_checkout_dir():
    from sed_jax.utils import compile_cache
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, '.jax_cache')
    proc = _run(_CACHE_PROBE, {})
    assert proc.returncode == 0, proc.stderr
    path, configured, _ = proc.stdout.split()
    assert path == configured == compile_cache.DEFAULT_DIR


def test_chip_smoke_refuses_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'chip_smoke.py')], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS='cpu'), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert 'needs a GPU' in proc.stderr


def test_main_path_serves_without_optional_packages():
    """flax, orbax, scikit-learn and h5py blocked: the main-path modules
    import and a small model serves two clips."""
    code = """
        import sys
        for name in ('flax', 'orbax', 'orbax.checkpoint', 'sklearn', 'h5py'):
            sys.modules[name] = None
        import jax, numpy as np
        import sed_jax.cli.common, sed_jax.cli.main_strong
        import sed_jax.cli.predict, sed_jax.train.checkpoint
        import sed_jax.train.state, sed_jax.train.step
        from sed_jax.config import AUDIO_8K
        from sed_jax.models.registry import get_model
        from sed_jax.serve.engine import SedInferenceEngine
        model = get_model('Cnn_9layers_FrameAvg', AUDIO_8K)
        variables = model.init({'params': jax.random.PRNGKey(0)},
                               np.zeros((1, 8000), np.float32), train=False)
        engine = SedInferenceEngine(model, variables, AUDIO_8K,
                                    sample_duration=1, batch_size=2)
        clips = np.random.RandomState(0).uniform(
            -0.5, 0.5, (2, 8000)).astype(np.float32)
        events, xmls = engine.predict_clips(clips, ['a.wav', 'b.wav'])
        assert len(xmls) == 2 and all('<AudioDoc' in x for x in xmls)
        assert not any(m in sys.modules and sys.modules[m] is not None
                       for m in ('flax', 'sklearn', 'h5py'))
        print('served')
    """
    proc = _run(code, {})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('served')
