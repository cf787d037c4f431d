"""swem_tpu_torch: SWEM video object segmentation in PyTorch with CUDA kernels.

A port of ``swem_tpu`` (JAX) to PyTorch on an NVIDIA Hopper GPU. Module
names mirror ``swem_tpu`` so each counterpart is easy to find. The port
imports nothing of JAX or of ``swem_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. On
a CUDA tensor the EM loop and the memory read run through the hand-written
kernels in ``csrc/``; the plain PyTorch versions beside them serve CPU
tensors only.
"""

__version__ = "0.1.0"
