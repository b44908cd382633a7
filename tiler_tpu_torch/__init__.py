"""tiler_tpu_torch: the GTM codec in PyTorch, for one NVIDIA H100
(sm_90a), beside the JAX package tiler_tpu that it is held against: the
encoder, checkpoint and resume, ingestion, the streaming and the
GOP-sharded encodes, the multi-device encoder (a device mesh, host
threads, torch.distributed processes), the decoders, the player, the
preview renderer and the command line.

It mirrors tiler_tpu's layout and names and stands alone: it imports
torch and numpy, never jax and nothing of tiler_tpu. What the two have
in common (config, constants, bitstream, the native C++ library, the
numpy decoder, the player, the preview renderer, ingestion, progress,
reindex order and the Save writer) it keeps as its own copies, held byte-exact against the originals by the tests. The
CUDA kernels and the C++ library are built at first use into
build/tiler_tpu_torch/ at the repository root. Exact argmins downstream of
the PsyV, k-means and 1-NN matmuls need full float32, so TF32 is turned
off for every matmul and convolution when the package is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import EncoderConfig, FTQuality  # noqa: E402,F401

__version__ = '0.1.0'
