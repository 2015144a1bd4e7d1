"""Lattice, rules, PRNG, engines, scenarios and the MCS loop of the port."""
