"""VGSL layers as torch modules."""
