from .ops import (HashSemiPlan, default_hash_semi_sizes,  # noqa: F401
                  hash_semi_plan)
