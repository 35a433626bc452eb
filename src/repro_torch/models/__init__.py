from repro_torch.models.transformer import (  # noqa: F401
    attention_launches, check_speculative, check_supported, encode,
    encoder_config, forward, has_cross, init_params, is_recurrent,
    layer_has_moe, layer_kind, layer_window, make_cache, make_paged_cache,
    norm_launches,
)
