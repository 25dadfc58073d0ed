"""Measurement scripts that run on a CUDA card beside chip_smoke.py."""
