from .ops import partition_plan, radix_histogram_ranks  # noqa: F401
