#!/bin/bash
# End-to-end workflow example, mirroring the reference run.sh stages.
# Set DATASET_DIR (audio + metadata) and WORKSPACE (artifacts) first.

DATASET_DIR=${DATASET_DIR:-"./dataset"}
WORKSPACE=${WORKSPACE:-"./workspace"}

MODEL="Cnn_9layers_Gru_FrameAtt"      # or Cnn_9layers_Transformer_FrameAtt, ...
COMMON="--dataset_dir $DATASET_DIR --workspace $WORKSPACE \
  --model_type $MODEL --loss_type clip_bce \
  --augmentation specaugment_timeshift_mixup --batch_size 32 \
  --feature_type logmel --audio_16k"

# 1. Pack each split into HDF5 (reference schema)
for SPLIT in weak_training strong_training strong_validation testing; do
  python -m sed_jax.cli.features pack_audio_files_to_hdf5 \
    --dataset_dir $DATASET_DIR --workspace $WORKSPACE \
    --data_type $SPLIT --audio_16k
done

# 2. Joint weak+strong training (data-parallel over all visible GPUs)
python -m sed_jax.cli.main_strong train $COMMON \
  --learning_rate 1e-3 --stop_iteration 50000

# 3. Test-set evaluation (also caches predictions for step 4)
python -m sed_jax.cli.main_strong inference_prob $COMMON

# 4. Per-class threshold optimization on the validation split
python -m sed_jax.cli.optimize_thresholds optimize_sed_thresholds \
  $COMMON --epochs 70

# 5. Evaluation with framewise-averaged overlapped windows / voting
python -m sed_jax.cli.main_strong inference_prob_overlap $COMMON --sed_thresholds
python -m sed_jax.cli.main_strong inference_prob_vote $COMMON --sed_thresholds

# 6. Production prediction: wav dir -> XML
python -m sed_jax.cli.predict predict \
  --input_dir ./wavs --workspace $WORKSPACE \
  --model_type $MODEL --loss_type clip_bce \
  --augmentation specaugment_timeshift_mixup --batch_size 32 \
  --feature_type logmel --audio_16k \
  --overlap --sample_duration 5 --sed_thresholds
