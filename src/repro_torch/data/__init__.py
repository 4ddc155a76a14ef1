"""Synthetic datasets with exact ground truth."""
