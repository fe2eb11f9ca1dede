"""Ansatz schedule compiler, batched simulation and the Gram build."""
