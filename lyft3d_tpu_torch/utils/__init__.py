"""Utilities: the flax → torch weight bridge."""
