"""Molecular dynamics: lattice, neighbor lists, integrator, simulation API."""
