"""Attention and other hand-written device kernels of the PyTorch port."""
