"""Data parallelism of the port: ``torch.distributed`` across processes, one a card."""
