"""Dataset layer: feature store, synthetic fixtures and the disk
descriptor store (numpy)."""

from acoss_tpu_torch.data.store import FeatureSet, pad_stack  # noqa: F401
from acoss_tpu_torch.data.synthetic import (  # noqa: F401
    LazySyntheticCorpus, make_synthetic_dataset)
