"""Synthetic data of the port (numpy copies of src/repro/data)."""
