"""Quantization-in-the-loop layers (CIM-native linear projections)."""
