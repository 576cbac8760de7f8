"""File formats of the PyTorch port (counterpart of ``trino_tpu/formats``)."""
