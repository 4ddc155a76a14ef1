"""Search, build and kernel-dispatch core of the PyTorch port."""
