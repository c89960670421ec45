"""Synthetic data (numpy), copied from the reference: acoustic clips
(``acoustic``) and token batches (``tokens``)."""
