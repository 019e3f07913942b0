"""Data of the port: the Fig-1 synthetic task, its partitions, batching
(per client and global), and the synthetic token stream of the LM."""

from repro_torch.data.loader import ClientBatcher, GlobalBatcher
from repro_torch.data.partition import (
    dirichlet_partition,
    group_label_skew_partition,
    iid_partition,
)
from repro_torch.data.synthetic import (
    SyntheticImageDataset,
    SyntheticLMDataset,
    make_confusable_image_classification,
    make_image_classification,
    make_lm_tokens,
)

__all__ = ["ClientBatcher", "GlobalBatcher", "dirichlet_partition",
           "group_label_skew_partition", "iid_partition",
           "SyntheticImageDataset", "make_confusable_image_classification",
           "make_image_classification",
           "SyntheticLMDataset", "make_lm_tokens"]
