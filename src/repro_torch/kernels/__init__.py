"""Kernels of the port: plain-torch versions (``ref``), the hand-written
CUDA kernels' wrappers (``flash_attention``, ``paged_attention``,
``rglru_scan``, ``stx_matmul``, ``stx_stencil``, ``vrp_dot``), their
nvcc build (``_build``) and the public dispatch (``ops``)."""
