"""Port of the JAX package's `ops/` subpackage."""
