"""Tensor helpers and input layouts."""
