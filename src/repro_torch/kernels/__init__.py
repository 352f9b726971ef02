"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, their
plain PyTorch versions (``ref.py``) and the device dispatch layer
(``ops.py``).  Nothing is compiled at import: ``build.py`` runs ``nvcc``
at first use."""
