"""Device ops of the PyTorch port: the fingerprint fold, the packed
enabled-mask words, and the sorted-set merge family with its CUDA
kernels (``csrc/``)."""
