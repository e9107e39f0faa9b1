"""The table and attention kernels: plain PyTorch versions (``ref.py``) beside hand-written
CUDA kernels for Hopper (``csrc/``), dispatched in each ``ops.py`` by the
device of the tensors they are given."""
