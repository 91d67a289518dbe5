"""Command-line entry points of the port, on the card unless ``--device cpu``:

  python -m far_tpu_torch.cli.train        -- training of the three families
  python -m far_tpu_torch.cli.evaluate     -- batched eval + metric tables
  python -m far_tpu_torch.cli.demo         -- single-pair pose inference
  python -m far_tpu_torch.cli.submission   -- map-free submission writer
  python -m far_tpu_torch.cli.precompute   -- matcher correspondence shards
  python -m far_tpu_torch.eval.mapfree_benchmark  -- offline submission scorer
"""
