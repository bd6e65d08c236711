"""Port of the JAX package's `consensus/` subpackage."""
