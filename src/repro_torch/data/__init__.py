"""Synthetic token data."""
