"""Kernels and host-side decoders of the recognition path."""
