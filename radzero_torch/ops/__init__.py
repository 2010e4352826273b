"""Primitives and the hand-written Hopper kernels with their plain twins."""
