"""Training of the port: supervision, losses, optimizer, trainer, checkpoints."""
