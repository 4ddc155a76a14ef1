"""Serving: the single-device plane and the query engine."""
