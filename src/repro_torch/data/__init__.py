"""Synthetic acoustic data (numpy), copied from the reference."""
