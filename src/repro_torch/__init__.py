"""PyTorch / CUDA port of the spectral-shifting attention system.

A standalone package beside the JAX reference (``src/repro``): it imports
``torch`` and numpy, never ``jax`` or anything of ``repro``. Its layout
mirrors the reference package module for module (``configs/``, ``core/``,
``kernels/``, ``models/``, ``serve/``, ``launch/``) so each port can be held
against its counterpart.

Where the reference drops to a Pallas TPU kernel, the port drops to a CUDA
C++ kernel for Hopper (``csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at
first use and bound with ``ctypes``, see ``kernels/build.py``). Every kernel
wrapper launches its kernel for CUDA tensors and runs the kernel's plain
PyTorch version for CPU tensors.
"""
