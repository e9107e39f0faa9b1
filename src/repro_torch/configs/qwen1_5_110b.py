"""Qwen1.5-110B [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-110B family; hf-tier]"""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    train=TrainSettings(microbatches=8, sharding="fsdp_tp",
                        loss_seq_chunks=4,
                        gqa_shard_opt=False, mlp_shard_opt=False),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=256, vocab=512, train=TrainSettings())
