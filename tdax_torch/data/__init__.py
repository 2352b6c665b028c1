"""Dataset generation and artifact IO (PyTorch port of ``tdax.data``)."""
