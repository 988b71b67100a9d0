"""Parity helpers for holding the port against the JAX reference, and the
fault-injection harness (``faults``) that rehearses refresh failures."""
