"""Communication helpers of the port (one process; DDP is not ported)."""
