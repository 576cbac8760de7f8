"""Worker meshes of the PyTorch port (counterpart of ``trino_tpu/parallel``)."""
