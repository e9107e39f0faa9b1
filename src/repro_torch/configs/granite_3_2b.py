"""Granite-3.0-2B [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155.  [hf:ibm-granite/granite-3.0-2b-base; hf-tier]"""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_head=64,
    d_ff=8192,
    vocab=49155,
    tie_embeddings=True,
    train=TrainSettings(microbatches=1,
                        gqa_shard_opt=False, mlp_shard_opt=False),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=256, vocab=512, train=TrainSettings())
