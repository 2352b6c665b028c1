"""End-to-end workflows of the PyTorch port."""
