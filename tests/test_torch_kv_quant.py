"""The port's contiguous int8 KV cache (``inference.kv_quant``) against
``repro.inference.kv_quant`` on the same numpy inputs: the counterparts of
``test_pipeline_kv_export.py``'s ``test_kv_quant_roundtrip_accuracy`` and
``test_kv_quant_attention_close_to_fp``.  Payloads and scales are bit for
bit the reference's; the dequantized cache and the attention over it agree
within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.inference import kv_quant as jx
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jx_decode_ref
from repro_torch.inference import kv_quant as tq
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

torch.set_num_threads(2)


def _randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _written(k, v, index, b, t, h, hd):
    jc = jx.write_kv(jx.make_quantized_cache(b, t, h, hd), jnp.asarray(k),
                     jnp.asarray(v), jnp.asarray(index, jnp.int32))
    tc = tq.write_kv(tq.make_quantized_cache(b, t, h, hd, device="cpu"),
                     torch.from_numpy(k), torch.from_numpy(v), index)
    return jc, tc


def test_kv_quant_roundtrip_accuracy():
    k = _randn(0, (2, 8, 4, 16))
    jc, tc = _written(k, k * 0.5, 3, 2, 32, 4, 16)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    kd, vd = tq.read_kv(tc, torch.float32)
    jkd, jvd = jx.read_kv(jc, jnp.float32)
    np.testing.assert_allclose(kd.numpy(), np.asarray(jkd), atol=1e-6)
    np.testing.assert_allclose(vd.numpy(), np.asarray(jvd), atol=1e-6)
    assert not kd[:, :3].any() and not kd[:, 11:].any()
    rel = float((kd[:, 3:11] - torch.from_numpy(k)).abs().max()
                / np.abs(k).max())
    assert rel < 0.02, rel           # int8 symmetric: <2% relative error
    assert tq.read_kv(tc)[0].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="past the cache"):
        tq.write_kv(tc, torch.from_numpy(k), torch.from_numpy(k), 30)


def test_kv_quant_attention_close_to_fp():
    """Decode attention over an int8 cache matches the fp cache closely,
    and the reference's over its own int8 cache."""
    b, h, t, hd = 2, 4, 32, 16
    q = _randn(1, (b, h, hd))
    k = _randn(2, (b, t, h, hd))
    v = _randn(3, (b, t, h, hd))
    jc, tc = _written(k, v, 0, b, t, h, hd)
    kd, vd = tq.read_kv(tc, torch.float32)
    tqt = torch.from_numpy(q)
    o_q = decode_attention_ref(tqt, kd.transpose(1, 2), vd.transpose(1, 2),
                               t, scale=0.25)
    o_f = decode_attention_ref(tqt, torch.from_numpy(k).transpose(1, 2),
                               torch.from_numpy(v).transpose(1, 2), t,
                               scale=0.25)
    assert float((o_q - o_f).abs().max()) < 0.05
    jkd, jvd = jx.read_kv(jc, jnp.float32)
    jo_q = jx_decode_ref(jnp.asarray(q), jkd.transpose(0, 2, 1, 3),
                         jvd.transpose(0, 2, 1, 3), t, scale=0.25)
    np.testing.assert_allclose(o_q.numpy(), np.asarray(jo_q), atol=1e-6)
