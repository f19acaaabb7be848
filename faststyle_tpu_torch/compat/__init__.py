"""Readers and writers of formats from outside the port (TF1 checkpoints)."""
