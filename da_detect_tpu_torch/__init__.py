"""DA-Detect in PyTorch for NVIDIA Hopper: the port of ``da_detect_tpu``.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package on the
ported path is a hand-written CUDA kernel here (``kernels/csrc``), with its
plain PyTorch version beside it in ``ops``. The package imports nothing of
JAX or of ``da_detect_tpu``. Importing it builds no kernel.
"""
