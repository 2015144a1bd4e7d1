"""PyTorch/CUDA port of the ESCG reproduction (the JAX package ``repro``
stays the reference).

The port runs ``core.simulation.simulate`` on all seven engines of the
reference (``reference``, ``batched``, ``sublattice``, ``pallas``,
``pallas_fused``, ``sharded`` and ``sharded_pod``) with its streaming
observables, and ``core.trials.run_trials`` on every engine but the
one-lattice ``sharded``; every TPU kernel of the reference has a
hand-written CUDA counterpart for Hopper (``kernels/csrc``). It imports
``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``. Its entry
points run on the card unless the caller passes ``device='cpu'``.
"""
