"""query subpackage of the PyTorch port (mirrors surface_multigrid_code_tpu/query)."""
