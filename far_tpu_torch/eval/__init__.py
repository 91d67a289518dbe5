"""Evaluation of the port: pose and matching metrics."""
