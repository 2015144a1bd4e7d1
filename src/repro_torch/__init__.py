"""PyTorch/CUDA port of the ESCG reproduction (the JAX package ``repro``
stays the reference).

The port runs ``core.simulation.simulate`` on the ``pallas_fused`` engine
with hand-written CUDA kernels for Hopper (``kernels/csrc``). It imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``. Its entry
points run on the card unless the caller passes ``device='cpu'``.
"""
