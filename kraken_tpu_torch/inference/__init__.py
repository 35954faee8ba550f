"""Inference engines of the port (recognition in this slice)."""
