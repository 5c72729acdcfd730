"""Serving: JSON HTTP viewer backend."""
