"""Training substrate of the port: data, optimizers, the train step,
checkpoints and fault tolerance (torch twin of ``repro.training``)."""
from repro_torch.training.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)
from repro_torch.training.data import DataConfig, TokenDataset, make_batch
from repro_torch.training.elastic import (
    Heartbeat,
    StepGuard,
    StragglerDetector,
    elastic_mesh,
)
from repro_torch.training.optimizer import (
    AdamW,
    Adafactor,
    cosine_lr,
    global_norm,
    make_optimizer,
)
from repro_torch.training.train_step import (
    TrainState,
    init_train_state,
    make_train_step,
)

__all__ = [
    "AsyncCheckpointer", "latest_step", "restore", "save",
    "DataConfig", "TokenDataset", "make_batch",
    "Heartbeat", "StepGuard", "StragglerDetector", "elastic_mesh",
    "AdamW", "Adafactor", "cosine_lr", "global_norm", "make_optimizer",
    "TrainState", "init_train_state", "make_train_step",
]
