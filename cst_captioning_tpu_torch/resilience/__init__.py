"""Fault handling of the training and serving paths."""
