"""Kernels of the port: plain-torch versions (``ref``), the hand-written
CUDA kernels' wrappers (``flash_attention``, ``paged_attention``), their
nvcc build (``_build``) and the public dispatch (``ops``)."""
