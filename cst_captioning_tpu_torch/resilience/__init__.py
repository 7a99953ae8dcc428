"""Fault handling of the training path."""
