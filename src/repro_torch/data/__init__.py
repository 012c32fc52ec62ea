"""Problem generators of the PyTorch port (mirrors ``repro.data``)."""
