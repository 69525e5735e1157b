"""Optimizers of the port (`adamw`)."""
