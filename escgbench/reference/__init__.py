"""The benchmark's plain reference: threefry2x32, Philox-4x32-10 and the
ESCG step of each engine's semantics, in plain PyTorch. It imports
nothing of the program or of the JAX package."""
