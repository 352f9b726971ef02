"""repro_torch — the ARCADE engine ported to PyTorch and hand-written CUDA
kernels for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``core``, ``core/index``,
``core/optimizer``, ``kernels``, ``obs``, ``analysis``) so each module's
counterpart sits at the same relative path, and imports nothing of it.
Entry points (``core.lsm.LSMStore``, ``kernels.ops``) run on the card
unless the caller passes ``device="cpu"``.
"""
