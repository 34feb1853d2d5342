"""Training of the port (counterparts of ``pointcloudprocessing_tpu/train``):
losses, the train, eval and predict steps for every model family (one
device, or several in the global and shard_map modes), the callbacks
(early stopping, torch checkpoints, resume, Ctrl-C), the staged trainer
``TrainProfile`` and its CLI."""

from pointcloudprocessing_tpu_torch.train.losses import (
    sparse_categorical_crossentropy,
    mean_squared_error,
    multi_head_loss,
)
from pointcloudprocessing_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_train_step,
    make_eval_step,
    init_train_state,
)
from pointcloudprocessing_tpu_torch.train.profile import TrainProfile, train_pointnet
from pointcloudprocessing_tpu_torch.train.hypertune import HyperTune, run_grid
from pointcloudprocessing_tpu_torch.train.callbacks import (
    EarlyStopping,
    BestCheckpoint,
    CtrlCInterruptHandler,
    load_checkpoint,
)

__all__ = [
    "sparse_categorical_crossentropy",
    "mean_squared_error",
    "multi_head_loss",
    "TrainState",
    "make_optimizer",
    "make_train_step",
    "make_eval_step",
    "init_train_state",
    "TrainProfile",
    "train_pointnet",
    "HyperTune",
    "run_grid",
    "EarlyStopping",
    "BestCheckpoint",
    "CtrlCInterruptHandler",
    "load_checkpoint",
]
