"""Granite-3.0-MoE-3B-A800M [moe] — 32L d_model=1536 24H (GQA kv=8)
expert d_ff=512 vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-3b-a800m-base family; hf-tier]

Assignment note: the header field says 40 experts, the trailing comment
says 32 — the explicit config field (40) wins (DESIGN.md §5).  40 experts
over a model axis of 16 relies on GSPMD padding (measured in roofline)."""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=0,
    vocab=49155,
    tie_embeddings=True,
    n_experts=40,
    top_k=8,
    d_expert_ff=512,
    train=TrainSettings(microbatches=1, moe_capacity_factor=1.25),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        vocab=512, n_experts=8, top_k=2, d_expert_ff=64,
        train=TrainSettings())
