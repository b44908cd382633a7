"""tiler_tpu_torch: the GTM encoder's single-device path in PyTorch, for
one NVIDIA H100 (sm_90a), beside the JAX package tiler_tpu that it is
held against.

It mirrors tiler_tpu's layout and names. Shared, JAX-free parts of
tiler_tpu (config, constants, bitstream, native, the numpy decoder,
checkpoint, progress, reindex order and the Save writer) are imported
unchanged; this package never imports jax. Exact argmins downstream of
the PsyV, k-means and 1-NN matmuls need full float32, so TF32 is turned
off for every matmul and convolution when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from tiler_tpu.config import EncoderConfig, FTQuality  # noqa: E402,F401

__version__ = '0.1.0'
