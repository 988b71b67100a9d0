"""Synthetic data generators (numpy) and the batch pipeline."""
