from .ops import (grouped_ranks, radix_permutation,  # noqa: F401
                  radix_rank, sortable_word, stable_partition_perm)
