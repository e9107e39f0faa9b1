from .ops import fused_bucket_ranks
from .ref import bucket_ids, fused_bucket_ranks_ref

__all__ = ["fused_bucket_ranks", "fused_bucket_ranks_ref", "bucket_ids"]
