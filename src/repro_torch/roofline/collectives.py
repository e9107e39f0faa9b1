"""Collective traffic and its ring cost (the counterpart of the JAX
package's ``roofline/hlo.py``).

The reference parses the collectives out of post-SPMD HLO; the port's
collectives are the calls of ``core/context.py``, which tell their
observers each one's name, result bytes and group (``cost.py`` counts
them).  What stays the same is the accounting: the *result* bytes on one
rank, converted to per-rank link bytes with the standard ring factors of
the group's size.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict          # per-device result bytes by op kind
    link_bytes: dict            # ring-model per-device link bytes by kind

    @property
    def total_link_bytes(self) -> float:
        return float(sum(self.link_bytes.values()))

    @property
    def total_result_bytes(self) -> float:
        return float(sum(self.result_bytes.values()))


def _ring_factor(op: str, group: int) -> float:
    if op == "collective-permute":
        return 1.0              # one hop of the full result, no groups attr
    if group <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (group - 1) / group
    if op == "all-gather":
        return float(group - 1) / group
    if op == "reduce-scatter":
        # result is the scattered shard; bytes moved ~ (group-1) * result
        return float(group - 1)
    if op == "all-to-all":
        return float(group - 1) / group
    return 1.0                  # collective-permute: one hop
