"""spsvo_tpu_torch — the SuperPoint stereo visual odometry pipeline in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `spsvo_tpu` (JAX) that mirrors its module names and public
layouts: trunk outputs stay NHWC, keypoints stay (x, y), and the NamedTuples
keep their field names, so the two packages compare like with like. The
package imports torch and numpy only; it never imports jax or `spsvo_tpu`.
"""
import torch as _torch

# The geometry stack (triangulation, Horn alignment, LM normal equations) is
# correctness-critical in fp32. cuBLAS matmuls and cuDNN convolutions may run
# in TF32 (~3 decimal digits) on Ampere and later; pin both to full fp32,
# the counterpart of the JAX package's float32 matmul-precision pin. The bf16
# trunk rounds its conv operands explicitly (models/graph.py), unaffected.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from spsvo_tpu_torch.config import (VOConfig, DetectorType, DescriptorType,  # noqa: E402
                                    MatcherType, SelectorType, Precision,
                                    MatchType)

__version__ = "0.1.0"
