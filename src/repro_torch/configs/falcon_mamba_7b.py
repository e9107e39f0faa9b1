"""Falcon-Mamba-7B [ssm] — 64L d_model=4096 attention-free, ssm_state=16,
vocab=65024 (mamba-1 architecture).  [arXiv:2410.05355; unverified-tier]

Attention-free => long_500k RUNS (O(1)-state decode); the paper's
attention-sharding discussion is inapplicable, but the HPTMT operator
substrate (data pipeline, DP training, shuffle) applies unchanged
(DESIGN.md §5)."""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,                       # mamba block replaces attn+ffn
    vocab=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    dt_rank=256,
    train=TrainSettings(microbatches=2),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=512, ssm_state=8, dt_rank=8,
        train=TrainSettings())
