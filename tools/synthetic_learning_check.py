"""End-to-end learning sanity check on real hardware.

Builds a synthetic separable dataset (each class = a distinct tone band;
strong labels mark the burst intervals), packs it with the real packing
pipeline, trains with the real CLI driver, and reports the validation
framewise mAP / ER trajectory.  If learning works, framewise mAP rises
far above chance within a few hundred iterations.

Usage:  python tools/synthetic_learning_check.py [workdir]
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from sed_jax.config import AUDIO_16K
from sed_jax.data import audio_io
from sed_jax.cli import features as features_cli
from sed_jax.cli import main_strong as main_strong_cli
from bench_corpus import (BANDS, N_CLASSES, make_clips)  # noqa: F401

CFG = AUDIO_16K


def synth_clip(rng, k):
    """One 10 s hardened-corpus training clip guaranteed to contain a
    class-k event (plus the corpus's random extras); returns
    (waveform, [(label, onset, offset)])."""
    del k  # class balance comes from make_clips's uniform class draw
    seed = int(rng.randint(1 << 31))
    clips, events = make_clips(1, CFG.sample_rate, seconds=10, seed=seed,
                               return_events=True, min_events=2,
                               max_events=3, min_dur=1.5, max_dur=3.0)
    spans = [(e['event_label'], e['onset'], e['offset'])
             for e in events[0]]
    return clips[0], spans


def build_dataset(root, n_per_split):
    rng = np.random.RandomState(0)
    meta = os.path.join(root, 'metadata')
    os.makedirs(os.path.join(meta, 'strong'), exist_ok=True)
    for split, n in n_per_split.items():
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        weak_rows, strong_rows = [], []
        for i in range(n):
            wav, spans = synth_clip(rng, i % N_CLASSES)
            name = f'{split}{i}_0.wav'
            audio_io.save_wav(os.path.join(d, name), wav, CFG.sample_rate)
            labels = sorted({lb for lb, _, _ in spans})
            weak_rows.append(
                f'{split}{i},0.000,10.000,"{",".join(labels)}",/m/x\n')
            for lb, s, e in spans:
                strong_rows.append(f'{name},{s:.3f},{e:.3f},{lb}\n')
        if split == 'testing':
            open(os.path.join(meta, 'testing_set.csv'), 'w').write(
                ''.join(weak_rows))
            open(os.path.join(
                meta, 'groundtruth_strong_label_testing_set.csv'),
                'w').write(''.join(strong_rows))
        else:
            open(os.path.join(meta, 'strong', f'{split}_set.csv'),
                 'w').write(''.join(weak_rows))
            if split != 'weak_training':
                open(os.path.join(
                    meta, 'strong',
                    f'groundtruth_strong_label_{split}_set.csv'),
                    'w').write(''.join(strong_rows))


def main():
    """Usage: synthetic_learning_check.py [workdir] [extra train args...]

    Extra args are forwarded to ``main_strong train`` (e.g.
    ``--compute_dtype bf16 --batch_size 8``) so dtype/batch variants can
    be checked for an equal loss trajectory against the f32 baseline."""
    workdir = (sys.argv[1] if len(sys.argv) > 1
               and not sys.argv[1].startswith('-')
               else tempfile.mkdtemp(prefix='sed_learn_'))
    extra = [a for a in sys.argv[1:] if a != workdir]
    dataset = os.path.join(workdir, 'dataset')
    ws = os.path.join(workdir, 'workspace')
    build_dataset(dataset, {'weak_training': 48, 'strong_training': 48,
                            'strong_validation': 16, 'testing': 16})
    for split in ('weak_training', 'strong_training', 'strong_validation',
                  'testing'):
        features_cli.main(['pack_audio_files_to_hdf5',
                           '--dataset_dir', dataset, '--workspace', ws,
                           '--data_type', split, '--audio_16k'])
    argv = [
        'train', '--dataset_dir', dataset, '--workspace', ws,
        '--model_type', 'Cnn_9layers_Gru_FrameAtt',
        '--loss_type', 'clip_bce', '--augmentation', 'specaugment_mixup',
        '--batch_size', '4', '--feature_type', 'logmel', '--audio_16k',
        '--learning_rate', '1e-3', '--stop_iteration', '601',
        '--eval_interval', '200']
    for i in range(0, len(extra), 2):            # later flags win
        if extra[i] in argv:
            j = argv.index(extra[i])
            argv[j + 1] = extra[i + 1]
        else:
            argv += [extra[i], extra[i + 1]]
    main_strong_cli.main(argv)
    print('done; see the logged valid/test framewise mAP + ER trajectory '
          f'in {ws}/logs')


if __name__ == '__main__':
    main()
