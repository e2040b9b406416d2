"""Model configurations: the port's copy of the JAX package's configs."""
