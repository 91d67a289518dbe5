"""Part of far_tpu_torch (see the package docstring)."""


def launch_counts():
    """{(wrapper, attribute): count} of every launch counter of the
    package's kernel wrappers: the integer attributes named ``launches*``
    (``launches``, and per route ``launches_tc`` / ``launches_tf32``)."""
    from far_tpu_torch.ops.backbone_glue import bn_act, bn_add_act, up2_add
    from far_tpu_torch.ops.bilinear_attention import bilinear_dual_softmax
    from far_tpu_torch.ops.fine_layer import fine_transformer
    from far_tpu_torch.ops.fivepoint import fivepoint_essential
    from far_tpu_torch.ops.loftr_layer import loftr_layer
    from far_tpu_torch.ops.matching_kernel import dual_softmax_rowcol
    from far_tpu_torch.ops.small_linalg import eigh_small, svd3

    return {(fn, name): value
            for fn in (loftr_layer, dual_softmax_rowcol, fine_transformer,
                       bilinear_dual_softmax, eigh_small, svd3, fivepoint_essential,
                       bn_act, bn_add_act, up2_add)
            for name, value in vars(fn).items() if name.startswith("launches")}
