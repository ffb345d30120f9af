from .norm import MaskedBatchNorm
from .segment import (global_add_pool, global_mean_pool,
                      masked_segment_max, masked_segment_mean,
                      masked_segment_sum)

__all__ = ["MaskedBatchNorm", "global_add_pool", "global_mean_pool",
           "masked_segment_max", "masked_segment_mean",
           "masked_segment_sum"]
