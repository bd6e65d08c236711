"""Port of the JAX package's `parallel/` subpackage."""
