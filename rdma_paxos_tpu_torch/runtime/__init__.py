"""Port of the JAX package's `runtime/` subpackage."""
