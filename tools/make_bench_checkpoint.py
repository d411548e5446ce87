"""Train the synthetic-learning-check model and export a repo-committable
checkpoint (the serving checks in chip_smoke.py and the tests use it).

This produces a REAL trained
Cnn_9layers_Gru_FrameAtt on the hardened 6-class corpus (tones, AM,
chirp, noise burst, near-Nyquist tone over diverse backgrounds — see
``tools/bench_corpus.py``) so the benched event distribution comes
from actual detections on content the wire-admission gate also
measures.

Usage: python tools/make_bench_checkpoint.py [workdir] [stop_iteration]
Writes tools/bench_checkpoint.npz (float16, ~9 MB).
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from sed_jax.utils.npz_ckpt import save_variables_npz  # noqa: E402
from sed_jax.cli import features as features_cli  # noqa: E402
from sed_jax.cli import main_strong as main_strong_cli  # noqa: E402
from synthetic_learning_check import build_dataset  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   'bench_checkpoint.npz')


def main():
    workdir = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix='sed_benchckpt_')
    stop = sys.argv[2] if len(sys.argv) > 2 else '801'
    dataset = os.path.join(workdir, 'dataset')
    ws = os.path.join(workdir, 'workspace')
    if not os.path.isdir(dataset):
        build_dataset(dataset, {'weak_training': 96, 'strong_training': 96,
                                'strong_validation': 24, 'testing': 24})
    for split in ('weak_training', 'strong_training',
                  'strong_validation', 'testing'):
        # per-split completeness: a killed earlier run can resume
        if not os.path.isfile(os.path.join(
                ws, 'hdf5s', f'{split}_logmel_16k.h5')):
            features_cli.main(['pack_audio_files_to_hdf5',
                               '--dataset_dir', dataset, '--workspace', ws,
                               '--data_type', split, '--audio_16k'])
    main_strong_cli.main([
        'train', '--dataset_dir', dataset, '--workspace', ws,
        '--model_type', 'Cnn_9layers_Gru_FrameAtt',
        '--loss_type', 'clip_bce', '--augmentation', 'specaugment_mixup',
        '--batch_size', '4', '--feature_type', 'logmel', '--audio_16k',
        '--learning_rate', '1e-3', '--stop_iteration', stop,
        '--eval_interval', '200'])

    from sed_jax.train.checkpoint import best_checkpoint_path, \
        load_variables
    from sed_jax.utils.paths import Workspace
    ckpt_root = Workspace(
        ws, augmentation='specaugment_mixup',
        batch_size=4).checkpoint_path('logmel', '16k')
    variables = load_variables(best_checkpoint_path(ckpt_root))
    save_variables_npz(OUT, variables)
    print(f'wrote {OUT} ({os.path.getsize(OUT) / 1e6:.1f} MB)')


if __name__ == '__main__':
    main()
