"""Device meshes of the port (port of ``repro.parallel``, the lattice part)."""
