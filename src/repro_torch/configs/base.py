"""Architecture + run configuration schema and registry.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing
of that package): every assigned architecture defines one module in
``repro_torch.configs`` with a
``CONFIG: ArchConfig`` at the exact published sizes and a ``reduced()``
smoke-test variant of the same family.  ``--arch <id>`` resolves through
:func:`get_config`.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """Per-arch runtime policy (sharding/memory knobs, hillclimb levers)."""

    microbatches: int = 1              # gradient-accumulation steps
    remat: str = "full"                # none | full | dots
    sharding: str = "tp"               # tp | fsdp_tp (2D weight sharding)
    opt_dtype: str = "float32"         # adam moment dtype (bf16 for 398B)
    use_zero1: bool = True             # shard optimizer state over data
    moe_capacity_factor: float = 2.0
    attn_q_chunk: int = 2048           # xla flash chunking
    attn_k_chunk: int = 2048
    loss_seq_chunks: int = 1           # chunk CE loss over seq (memory lever)
    # --- beyond-paper perf levers (EXPERIMENTS.md §Perf; all default ON,
    # set False to reproduce the paper-faithful baseline lowering) ---
    gqa_shard_opt: bool = True         # grouped-GQA sharding + local KV repeat
    bf16_weight_cast: bool = True      # cast matmul weights bf16 at the top
    grad_2d_accum: bool = True         # ZeRO-2D grad accumulator constraint
    ssm_shard_opt: bool = True         # shard mamba activations' E dim over
                                       # model (stops GSPMD replicating
                                       # in_proj/out_proj + their grads)
    mlp_shard_opt: bool = True         # pin swiglu/gelu f-dim to model


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int                       # 0 => attention-free
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert_ff: int = 0
    n_shared_experts: int = 0
    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0
    # hybrid interleave (jamba): attention every `attn_period` layers,
    # MoE every `moe_period` layers
    attn_period: int = 0
    moe_period: int = 0
    # enc-dec
    encoder_layers: int = 0
    enc_len_ratio: int = 4             # encoder frames = seq // ratio
    # modality frontend stub
    frontend: str = "none"             # none | vision | audio
    frontend_tokens: int = 0           # vision: patch tokens prepended
    # training policy
    train: TrainSettings = TrainSettings()

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    def padded_vocab(self, multiple: int = 256) -> int:
        return math.ceil(self.vocab / multiple) * multiple

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, V = self.d_model, self.padded_vocab()
        total = V * d                                   # embed
        if not self.tie_embeddings:
            total += d * V                              # lm_head
        layers = []
        n_dec = self.n_layers
        for i in range(n_dec):
            layers.append(self._layer_params(i))
        total += sum(layers)
        if self.is_encdec:
            enc_layer = (4 * self.n_heads * self.d_head * d
                         + 2 * d * self.d_ff + 2 * d)
            total += self.encoder_layers * enc_layer
        return total

    def _layer_params(self, i: int) -> int:
        d = self.d_model
        n = 0
        if self._layer_has_attention(i):
            hq = self.n_heads * self.d_head
            hkv = self.n_kv_heads * self.d_head
            n += d * hq + 2 * d * hkv + hq * d
            if self.qkv_bias:
                n += hq + 2 * hkv
            if self.is_encdec:            # decoder cross-attention
                n += d * hq + 2 * d * hkv + hq * d + d
        else:                              # mamba block
            E, N, K = self.d_inner, self.ssm_state, self.ssm_conv
            dtr = self.dt_rank or max(1, math.ceil(d / 16))
            n += d * 2 * E + K * E + E * (dtr + 2 * N) + dtr * E \
                + E * N + E + E * d
        if self._layer_has_moe(i):
            f = self.d_expert_ff or self.d_ff
            n += d * self.n_experts \
                + self.n_experts * 3 * d * f \
                + self.n_shared_experts * 3 * d * f
        elif self.d_ff > 0:
            n += 3 * d * self.d_ff if self.family != "audio" \
                else 2 * d * self.d_ff
        n += 2 * d                                       # norms
        return n

    def _layer_has_attention(self, i: int) -> bool:
        if self.attention_free:
            return False
        if self.attn_period > 1:        # jamba: one attn layer per period
            return (i % self.attn_period) == (self.attn_period - 1)
        return True

    def _layer_has_moe(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        if self.moe_period > 1:
            return (i % self.moe_period) == 1
        return True

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        f = self.d_expert_ff or self.d_ff
        total = self.param_count()
        for i in range(self.n_layers):
            if self._layer_has_moe(i):
                inactive = (self.n_experts - self.top_k) * 3 * d * f
                total -= inactive
        return total


# --------------------------------------------------------------------------
# Input-shape cells (assigned): every LM arch is paired with these four.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                           # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# archs whose every layer is quadratic full attention skip long_500k
# (no sub-quadratic path; see DESIGN.md §5)
LONG_CONTEXT_ARCHS = ("falcon-mamba-7b", "jamba-1.5-large-398b")


ARCH_IDS = (
    "qwen1.5-110b",
    "minitron-4b",
    "mistral-large-123b",
    "granite-3-2b",
    "qwen3-moe-235b-a22b",
    "granite-moe-3b-a800m",
    "internvl2-2b",
    "seamless-m4t-large-v2",
    "falcon-mamba-7b",
    "jamba-1.5-large-398b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_MODULES["unomt"] = "unomt"
_MODULES["lm100m"] = "lm100m"


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"{__package__}.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"{__package__}.{_MODULES[arch]}")
    return mod.reduced()


def cells_for(arch: str) -> Sequence[str]:
    if arch in ("unomt", "lm100m"):
        return ("train_4k",)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return tuple(cells)
