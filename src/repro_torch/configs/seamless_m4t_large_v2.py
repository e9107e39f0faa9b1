"""SeamlessM4T-Large-v2 [audio] — enc-dec, 24+24L d_model=1024 16H
(kv=16 -> MHA) d_ff=8192 vocab=256206.  [arXiv:2308.11596; hf-tier]

Backbone only: the speech frontend is a stub — ``input_specs()`` provides
precomputed frame embeddings (seq // enc_len_ratio frames) for the
encoder.  The decoder is a standard causal LM with cross-attention, so the
decode shapes lower ``serve_step`` against the decoder."""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                  # decoder layers
    encoder_layers=24,
    enc_len_ratio=4,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab=256206,
    frontend="audio",
    train=TrainSettings(microbatches=1, loss_seq_chunks=4),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=256, vocab=512,
        train=TrainSettings())
