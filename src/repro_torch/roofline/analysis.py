"""Three-term roofline of one port step (the counterpart of the JAX
package's ``roofline/analysis.py``), priced at NVIDIA H100 SXM constants.

Constants (H100 SXM datasheet): 989 TFLOP/s dense bf16 on the tensor
cores, 67 TFLOP/s float32 outside them, 3.35 TB/s HBM3, NVLink 4 at
450 GB/s each way per GPU within an 8-GPU node, and across nodes one
ConnectX-7 NDR (400 Gb/s) link of 50 GB/s per GPU.  A mesh's ranks are
row-major (the last axis fastest, ``launch/mesh.py``) and fill nodes of
8 in order, so a group of ranks that spans several nodes is priced at the
NDR rate: at 16 x 16 and 2 x 16 x 16 that is every axis group (a model
group is 16 consecutive ranks, two nodes; a data group strides 16 ranks,
a pod group 256), and every group of 8 or fewer consecutive ranks is
priced at NVLink.

Terms (seconds/step, per rank; the counted step is one rank's program,
so its FLOPs and bytes are per-device already):

    compute    = flops_per_device / PEAK_FLOPS + kernel_op_s
    memory     = bytes_per_device / HBM_BW
    collective = ring-model link bytes per device / the link's rate

As in the reference, every FLOP is priced at the bf16 peak: the port's
float32 products (the loss's logits, the Mamba projections' sums) would
take longer, so ``compute_s`` is a lower bound; ``flops_f32_per_dev``
says how many of the FLOPs had float32 operands.  ``kernel_op_s`` is
the seconds of the operations of the hand-written kernels other than
flash attention (the Mamba scan's float32 updates and exponentials, the
partition's compares), each at its own rate (``cost.kernel_work``):
they are not tensor-core FLOPs, and count in no FLOP field.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .collectives import CollectiveStats

PEAK_FLOPS = 989e12          # dense bf16 tensor-core op/s (H100 SXM)
F32_FLOPS = 67e12            # float32 op/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 B/s
# special-function (exp2) results: 16 per SM per clock, 132 SMs, 1.98 GHz
EXP_PER_S = 16 * 132 * 1.98e9
NVLINK_BW = 450e9            # NVLink 4, B/s each way per GPU, in a node
NDR_BW = 50e9                # ConnectX-7 NDR, B/s per GPU, across nodes
NODE_GPUS = 8                # GPUs an NVLink node holds


@dataclasses.dataclass
class Roofline:
    arch: str
    cell: str
    mesh: str
    flops_per_dev: float
    bytes_per_dev: float
    collective: CollectiveStats
    model_flops: float                   # 6ND (train) / 2ND (inference)
    n_chips: int
    memory_per_dev: dict | None = None
    ndr_link_bytes: float = 0.0          # the link bytes that cross nodes
    flops_f32_per_dev: float = 0.0       # FLOPs with float32 operands
    kernel_op_s: float = 0.0             # other kernels' operations, s

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS + self.kernel_op_s

    @property
    def memory_s(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        nvlink = self.collective.total_link_bytes - self.ndr_link_bytes
        return nvlink / NVLINK_BW + self.ndr_link_bytes / NDR_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        counted = self.flops_per_dev * self.n_chips
        return self.model_flops / counted if counted else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_s * PEAK_FLOPS * self.n_chips
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "arch": self.arch, "cell": self.cell, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "flops_per_dev": self.flops_per_dev,
            "flops_f32_per_dev": self.flops_f32_per_dev,
            "kernel_op_s": self.kernel_op_s,
            "bytes_per_dev": self.bytes_per_dev,
            "collective_result_bytes": self.collective.result_bytes,
            "collective_link_bytes": self.collective.link_bytes,
            "collective_counts": self.collective.counts,
            "collective_ndr_link_bytes": self.ndr_link_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "step_s": self.step_s,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu": self.mfu,
            "memory_per_dev": self.memory_per_dev,
        }


def model_flops_for(cfg, cell_name) -> float:
    """6·N_active·D for train, 2·N_active·D for inference steps
    (``cell_name``: a cell of ``SHAPES``, or a ``ShapeCell``)."""
    from ..configs import SHAPES
    sh = SHAPES[cell_name] if isinstance(cell_name, str) else cell_name
    n = cfg.active_param_count()
    if sh.kind == "train":
        tokens = sh.global_batch * sh.seq_len
        return 6.0 * n * tokens
    if sh.kind == "prefill":
        tokens = sh.global_batch * sh.seq_len
        return 2.0 * n * tokens
    tokens = sh.global_batch            # one token per sequence
    return 2.0 * n * tokens
