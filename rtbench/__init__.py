"""The benchmark of the PyTorch and CUDA renderer (``rtbench/run.py``)."""
