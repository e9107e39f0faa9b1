from .ops import (HashJoinPlan, default_hash_join_sizes,  # noqa: F401
                  hash_join_plan)
