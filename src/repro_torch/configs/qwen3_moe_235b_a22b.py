"""Qwen3-MoE-235B-A22B [moe] — 94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936, MoE 128 experts top-8, QK-norm.
[hf:Qwen/Qwen3-235B-A22B family; hf-tier]

This is the hero cell for the paper's technique: MoE dispatch is the HPTMT
table Shuffle operator (DESIGN.md §2)."""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=0,                       # every layer is MoE (no dense FFN)
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    d_expert_ff=1536,
    train=TrainSettings(microbatches=4, sharding="fsdp_tp",
                        opt_dtype="bfloat16", loss_seq_chunks=4),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        vocab=512, n_experts=8, top_k=2, d_expert_ff=64,
        train=TrainSettings())
