"""Data of the port: the Fig-1 synthetic task, its partition, batching,
and the synthetic token stream of the LM prompts."""

from repro_torch.data.loader import ClientBatcher
from repro_torch.data.partition import group_label_skew_partition
from repro_torch.data.synthetic import (
    SyntheticImageDataset,
    SyntheticLMDataset,
    make_confusable_image_classification,
    make_lm_tokens,
)

__all__ = ["ClientBatcher", "group_label_skew_partition",
           "SyntheticImageDataset", "make_confusable_image_classification",
           "SyntheticLMDataset", "make_lm_tokens"]
