"""Training driver: jit'd step, optax, eval, checkpointing (SURVEY.md T5)."""

from bignn.train.metrics import roc_auc, average_precision, roc_auc_jnp, average_precision_jnp
from bignn.train.trainer import Trainer, MinibatchTrainer, TrainConfig

__all__ = [
    "roc_auc",
    "average_precision",
    "roc_auc_jnp",
    "average_precision_jnp",
    "Trainer",
    "MinibatchTrainer",
    "TrainConfig",
]
