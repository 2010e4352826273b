"""Tools of the port that run without the JAX package."""
