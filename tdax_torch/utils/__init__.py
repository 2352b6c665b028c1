"""Small utilities of the PyTorch port (port of ``tdax.utils``)."""
