"""Measurement tools of the PyTorch/CUDA port."""
