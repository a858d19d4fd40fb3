"""Dataset layer: feature store and synthetic fixtures (numpy)."""

from acoss_tpu_torch.data.store import FeatureSet, pad_stack  # noqa: F401
from acoss_tpu_torch.data.synthetic import make_synthetic_dataset  # noqa: F401
