"""acoss_tpu_torch: the PyTorch/CUDA port of acoss_tpu for NVIDIA Hopper.

The JAX package `acoss_tpu` is the reference this port is checked
against; this package imports neither it nor JAX, so it runs on a machine
that has only PyTorch and the CUDA toolkit. Module names mirror the JAX
package:

- ``acoss_tpu_torch.features``      audio -> per-track features (spectral
                                    stages on the device, the chord HMM's
                                    forward-backward a kernel)
- ``acoss_tpu_torch.data``          padded feature store + synthetic corpora
- ``acoss_tpu_torch.ops``           CRP math, downsampling and the qmax/dmax
                                    aligners; ``*_cuda`` modules hold the
                                    wrappers of the hand-written CUDA kernels
                                    under ``csrc/``
- ``acoss_tpu_torch.benchmarking``  the pair-grid harness, the twelve
                                    algorithm classes and the retrieval
                                    evaluation
- ``acoss_tpu_torch.serving``       ``CoverIndex``: 1 x N queries against a
                                    corpus kept on the device
- ``acoss_tpu_torch.parallel``      process shards of the pair grid and
                                    their merge
- ``acoss_tpu_torch.analytics``     the "what is a cover?" studies
- ``acoss_tpu_torch.utils``         profiling, stage timing, logging
"""

__version__ = "0.1.0"
