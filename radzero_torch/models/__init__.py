"""Model configs, towers and the composite RadZero model (PyTorch port)."""
