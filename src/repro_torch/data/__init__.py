"""Data of the port: the Fig-1 synthetic task, its partition, batching."""

from repro_torch.data.loader import ClientBatcher
from repro_torch.data.partition import group_label_skew_partition
from repro_torch.data.synthetic import (
    SyntheticImageDataset,
    make_confusable_image_classification,
)

__all__ = ["ClientBatcher", "group_label_skew_partition",
           "SyntheticImageDataset", "make_confusable_image_classification"]
