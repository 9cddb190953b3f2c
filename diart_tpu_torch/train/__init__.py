from .segmentation import (
    DataParallel,
    TrainState,
    make_train_state,
    pit_bce_loss,
    train_step,
)
from .embedding import (
    aam_softmax_loss,
    embedding_train_step,
    make_embedding_train_state,
)
from .checkpoint import latest_checkpoint, restore_train_state, save_train_state

__all__ = [
    "DataParallel",
    "TrainState",
    "make_train_state",
    "pit_bce_loss",
    "train_step",
    "aam_softmax_loss",
    "make_embedding_train_state",
    "embedding_train_step",
    "save_train_state",
    "restore_train_state",
    "latest_checkpoint",
]
