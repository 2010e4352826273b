"""Primitives and the hand-written Hopper kernels with their plain twins."""


def counted_wrappers() -> tuple:
    """Every kernel wrapper that counts its launches (``.launches``), in one order:
    the one list that the tools and ``chip_smoke.py`` read and reset."""
    from radzero_torch.ops import flash_attention as fa
    from radzero_torch.ops import fused_layer as fl
    from radzero_torch.ops import vlcabs_fused as vf

    return (fl.fused_preattn, fl.flash_attention_packed, fl.fused_postattn, fl.fused_mpnet_post,
            vf.vlcabs_fused, fl.fused_preattn_bwd, fl.flash_attention_packed_bwd,
            fl.fused_postattn_bwd, fl.fused_mpnet_post_bwd, vf.vlcabs_train_forward,
            vf.vlcabs_train_bwd_dq, vf.vlcabs_train_bwd_dtn, fa.flash_attention,
            fa.flash_attention_bwd, fa.flash_attention_bias, fa.flash_attention_bias_bwd,
            fl.fused_postattn_tp, fl.fused_mpnet_post_tp, fl.tp_rows, fl.fused_preattn_bwd_tp,
            fl.fused_postattn_bwd_tp, fl.fused_mpnet_post_bwd_tp)
