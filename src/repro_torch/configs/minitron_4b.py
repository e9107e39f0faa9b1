"""Minitron-4B [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned Nemotron.  [arXiv:2407.14679; hf-tier]

Note: 24 heads are not divisible by the model axis (16) — GSPMD pads;
measured in the roofline (DESIGN.md §5)."""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_head=128,
    d_ff=9216,
    vocab=256000,
    train=TrainSettings(microbatches=2, loss_seq_chunks=4,
                        gqa_shard_opt=False, mlp_shard_opt=False),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_head=16,
        d_ff=256, vocab=512, train=TrainSettings())
