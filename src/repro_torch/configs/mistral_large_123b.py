"""Mistral-Large-123B [dense] — 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407;
unverified-tier]"""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab=32768,
    rope_theta=1_000_000.0,
    train=TrainSettings(microbatches=8, sharding="fsdp_tp",
                        gqa_shard_opt=False, mlp_shard_opt=False),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=256, vocab=512, train=TrainSettings())
