"""PyTorch/CUDA port of the ESCG reproduction (the JAX package ``repro``
stays the reference).

The port runs ``core.simulation.simulate`` on the sublattice engines
(``pallas_fused``, ``pallas``, ``sublattice``) with its streaming
observables, and every TPU kernel of the reference has a hand-written
CUDA counterpart for Hopper (``kernels/csrc``). It imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``. Its entry points run on
the card unless the caller passes ``device='cpu'``.
"""
