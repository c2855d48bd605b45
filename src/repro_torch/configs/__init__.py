"""Model configurations: the JAX package's ten architectures, as data."""
