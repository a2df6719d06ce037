"""PyTorch/CUDA port of ``neuralsvd_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``data/``, ``operators/``, ``methods/``, ``training/``) so each module's
counterpart is easy to find, and never imports JAX or the JAX package.

Entry points place their tensors on ``device="cuda"`` unless the caller
names another device; with no GPU present that default raises instead of
falling back to the CPU (see :func:`neuralsvd_tpu_torch.device.resolve_device`).
"""
