"""InternVL2-2B [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT frontend + InternLM2 backbone.
[arXiv:2404.16821; hf-tier]

Per the assignment, only the transformer BACKBONE is modeled; the vision
frontend is a stub: ``input_specs()`` provides precomputed patch
embeddings (256 tokens) prepended to the text sequence."""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab=92553,
    frontend="vision",
    frontend_tokens=256,
    train=TrainSettings(microbatches=1,
                        gqa_shard_opt=False, mlp_shard_opt=False),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=256, vocab=512, frontend_tokens=16, train=TrainSettings())
