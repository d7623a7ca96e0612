"""Pytree helpers of the port."""
