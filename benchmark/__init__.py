"""The benchmark of the PyTorch and CUDA port (``neuralsvd_tpu_torch``)."""
