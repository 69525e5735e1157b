"""Parallel explore engines of the port: the device-mesh explorer."""
