from repro_torch.models.transformer import (  # noqa: F401
    REMAT_POLICIES, active_param_count, attention_launches,
    check_speculative, check_supported, check_trainable, encode,
    encoder_config, forward, has_cross, init_params, is_recurrent,
    layer_has_moe, layer_kind, layer_window, loss_fn, make_cache,
    make_paged_cache, norm_launches, param_count,
)
