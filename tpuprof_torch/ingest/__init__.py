"""ingest of the PyTorch port."""
