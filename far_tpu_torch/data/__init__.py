"""Data of the port: synthetic image pairs."""
