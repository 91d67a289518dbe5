"""Scripts that drive the port on the card."""
