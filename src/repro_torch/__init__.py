"""``repro_torch`` — the PyTorch/CUDA port of :mod:`repro` for one H100.

The package mirrors ``repro``'s layout (``sparse/``, ``data/``,
``kernels/``, ``core/``, ``cluster/``) and computes the same functions with
torch tensors.  Every kernel that ``repro`` wrote in Pallas for the TPU is
a hand-written CUDA C++ kernel for ``sm_90a`` here (``csrc/``), built with
``nvcc`` at first use; each has a plain PyTorch version beside it
(``kernels/ref.py``) that runs when the operands lie on the CPU.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when no GPU is present: the CPU runs only when the caller asks for it.
The package imports torch and numpy, never JAX and nothing of ``repro``.
"""
