"""PyTorch / CUDA port of multigrid_feanet_tpu.

The package runs the fused V(1,1) multigrid solve of the bi-material Q1
Poisson problem (``solvers/mg2.py``) on hand-written CUDA kernels
(``csrc/sweep.cu``, bound in ``ops/sweep.py``).  Every kernel has a plain
PyTorch twin in the same module: tensors on the CPU take the twin, tensors on
a CUDA device launch the kernel.  Entry points default to the CUDA device
and raise when there is none; pass ``device="cpu"`` to run the plain path.
"""
