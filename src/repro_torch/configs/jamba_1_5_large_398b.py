"""Jamba-1.5-Large-398B [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, Mamba:attention 7:1 interleave, MoE 16e top-2
every 2nd layer.  [arXiv:2403.19887; hf-tier]

Hybrid => long_500k RUNS: mamba layers carry the long context with O(1)
state; the 9 attention layers keep a (sharded) 524k KV cache."""
import dataclasses

from .base import ArchConfig, TrainSettings

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    d_expert_ff=24576,
    attn_period=8,                # layer 7 of each 8-block is attention
    moe_period=2,                 # odd layers are MoE
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    dt_rank=512,
    train=TrainSettings(microbatches=8, sharding="fsdp_tp",
                        opt_dtype="bfloat16"),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, attn_period=2, moe_period=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, n_experts=8, top_k=2,
        d_expert_ff=128, vocab=512, ssm_state=8, dt_rank=8,
        train=TrainSettings())
