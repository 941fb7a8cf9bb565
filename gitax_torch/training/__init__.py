"""Training, the counterpart of `gitax.training`: the label-smoothed loss,
the AdamW step, the TSV fine-tuning loop and SCST."""

from .loss import smooth_label_cross_entropy, caption_loss
from .trainer import TrainState, make_train_step, init_train_state, default_optimizer
from .finetune import (
    TSVCaptionDataset,
    batch_iterator,
    evaluate_model_on_tsv,
    run_finetune,
    run_scst,
)
