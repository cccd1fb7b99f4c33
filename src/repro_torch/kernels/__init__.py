"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ops`` holds one wrapper per kernel (the only entry the rest of the
package calls), ``ref`` the plain versions, ``_build`` the ``nvcc`` build
and ctypes loading.  Each kernel module (``esicp_gather``, ``sparse_sim``,
``esicp_filter``, ``segment_update``, ``rho_gather``, ``sketch_sim``,
``flash_attention``, ``routed_scan``, ``slstm_scan``) carries its
launchers and a note on the TPU kernel (or, for ``routed_scan`` and
``slstm_scan``, the plain JAX scan) it replaces and what bounds it on the
card.
Nothing is compiled or loaded when these modules are imported.
"""
