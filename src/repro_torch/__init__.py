"""PyTorch/CUDA port of the HPTMT distributed table operators.

The layout mirrors the JAX package module for module
(``core/{table,kernel_backend,context,partition,local_ops,dist_ops}.py``
and ``kernels/<name>/{ref.py,ops.py}`` with the CUDA sources under
``kernels/csrc/``), so every function has a counterpart of the same name.
Functions take and return plain tensors on an explicit device; nothing is
traced or jitted.  The hand-written Hopper kernels run for CUDA tensors,
their plain PyTorch versions for CPU tensors.
"""
