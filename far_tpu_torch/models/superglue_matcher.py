"""SuperPoint + SuperGlue as a matcher of the map-free request.

``SuperGlueMatcher`` holds the detector (``models/superpoint.py``) and
the matcher (``models/superglue.py``) and answers ``match(batch)`` as
``FARLoFTR.match`` does for ``pipeline.mapfree_forward``: its
``matches`` carry the (B, K) padded correspondences ``mkpts0_f``,
``mkpts1_f`` and ``valid`` (K = ``max_keypoints``, zero where a slot is
not valid), with the detections, descriptors and assignment beside them.
Both images go through SuperPoint as one batch. Every shape is static
and nothing is read back on the host, so the request captures in one
CUDA graph. The stages end in the marks ``DETECT``, ``GNN`` and
``SINKHORN`` (``utils.prof.mark``); the map-free request's counters are
``mapfree_sg.capture.*``. Child modules are ``superpoint`` and
``superglue``, with each module's own parameter names after the prefix.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from far_tpu_torch.models.superglue import SuperGlue, SuperGlueConfig, select_matches
from far_tpu_torch.models.superpoint import SuperPoint, SuperPointConfig
from far_tpu_torch.types import KeypointMatcherOutput, KeypointMatches, PairBatch
from far_tpu_torch.utils.prof import DETECT, GNN, SINKHORN, mark


class SuperGlueMatcher(nn.Module):
    # the stages ``match`` marks, and the map-free request's counters
    MATCH_STAGES = (DETECT, GNN, SINKHORN)
    MAPFREE_PREFIX = "mapfree_sg"

    def __init__(self, sp_cfg: SuperPointConfig, sg_cfg: SuperGlueConfig):
        super().__init__()
        self.superpoint = SuperPoint(sp_cfg)
        self.superglue = SuperGlue(sg_cfg)

    def match(self, batch: PairBatch) -> KeypointMatcherOutput:
        """(B, H, W, 1) gray pair in [0, 1] -> SuperPoint on both images,
        SuperGlue's scores, Sinkhorn and the mutual selection over the
        threshold."""
        B = batch.image0.shape[0]
        k, s, v, d = self.superpoint(torch.cat([batch.image0, batch.image1]))
        (k0, k1), (s0, s1), (v0, v1), (d0, d1) = (x.split(B) for x in (k, s, v, d))
        mark(DETECT)
        sg = self.superglue
        scores = sg.scores(k0, s0, v0, d0, k1, s1, v1, d1, tuple(batch.image0.shape[1:3]))
        mark(GNN)
        m0, mconf = select_matches(sg.transport(scores, v0, v1), v0, sg.cfg.match_threshold)
        m0 = m0.long()
        ok = m0 >= 0
        pts1 = torch.gather(k1, 1, m0.clamp(min=0)[..., None].expand(-1, -1, 2))
        mark(SINKHORN)
        return KeypointMatcherOutput(KeypointMatches(
            kpts0=k0, kpts1=k1, scores0=s0, scores1=s1, kvalid0=v0, kvalid1=v1, desc0=d0,
            desc1=d1, matches0=m0, mconf=mconf, valid=ok, mkpts0_f=k0 * ok[..., None],
            mkpts1_f=pts1 * ok[..., None]))
