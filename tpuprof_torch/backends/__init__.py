"""backends of the PyTorch port."""
