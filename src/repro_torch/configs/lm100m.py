"""~100M-class dense LM for the end-to-end training example
(examples/train_lm.py): 12L d_model=768 12H d_ff=3072, tied embeddings."""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="lm100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab=32768,
    tie_embeddings=True,
    train=TrainSettings(microbatches=1),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_head=32,
        d_ff=512, vocab=1024, train=TrainSettings())
