"""Measurement scripts of the PyTorch port, each run on its own."""
