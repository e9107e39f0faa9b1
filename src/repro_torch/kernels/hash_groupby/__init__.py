from .ops import (HashGroupbyPlan, default_hash_groupby_sizes,  # noqa: F401
                  hash_groupby_plan)
