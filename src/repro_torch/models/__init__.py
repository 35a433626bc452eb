from repro_torch.models.transformer import (  # noqa: F401
    check_supported, forward, init_params, is_recurrent, layer_window,
    make_cache, make_paged_cache,
)
