from repro_torch.kernels.aggregate.ops import (
    masked_scaled_aggregate,
    masked_scaled_aggregate_update,
)
from repro_torch.kernels.aggregate.ref import (
    masked_scaled_aggregate_ref,
    masked_scaled_aggregate_update_ref,
)

__all__ = ["masked_scaled_aggregate", "masked_scaled_aggregate_update",
           "masked_scaled_aggregate_ref", "masked_scaled_aggregate_update_ref"]
