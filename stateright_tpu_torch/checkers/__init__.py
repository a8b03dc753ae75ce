"""Device checkers of the PyTorch port."""
