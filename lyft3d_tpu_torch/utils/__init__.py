"""Utilities: the flax → torch weight bridge, the torch-checkpoint importer,
profiler helpers, debug images, a progress bar."""
