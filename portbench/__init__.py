"""The benchmark of the PyTorch and CUDA port (``compu_tpu_torch``)."""
