"""PyTorch and CUDA port of the GBA reproduction, for NVIDIA Hopper.

A package beside the JAX package ``repro``, with its layout and public
names.  It imports ``torch``, ``numpy`` and the standard library only;
every TPU kernel on a ported path is a hand-written CUDA kernel under
``kernels/csrc/``, built at first launch.  Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.

Ported so far: the recsys scoring path (``repro_torch.serving``); the
GBA replay trainer with DeepFM (``repro_torch.core``,
``repro_torch.launch.quickstart``) and the sparse-module smoke; the LM's
fused flat-buffer GBA step and its worker-parallel step with the quantized
gradient-routing wire (``repro_torch.launch.train``).
"""
