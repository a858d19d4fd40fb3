"""Dataset layer: feature store, synthetic fixtures and the disk
descriptor store (numpy)."""

from acoss_tpu_torch.data.store import (  # noqa: F401
    FeatureSet, concat_feature_sets, pad_stack)
from acoss_tpu_torch.data.synthetic import (  # noqa: F401
    LazySyntheticCorpus, make_synthetic_dataset)
