"""lwsnet_tpu_torch: the anytime stereo-depth engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `lwsnet_tpu`, which stays the reference. This
package imports torch, numpy and the standard library only.
"""

from lwsnet_tpu_torch.config import ModelConfig
from lwsnet_tpu_torch.inference import InferenceEngine, make_forward
from lwsnet_tpu_torch.models.lwsnet import LWSNet

__version__ = "0.1.0"
