"""Evaluation of the port: pose and matching metrics, and the visloc
multi-reference localisation."""

from far_tpu_torch.eval import localize  # noqa: F401  (visloc-relapose eval)
