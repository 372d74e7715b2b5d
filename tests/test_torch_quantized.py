"""The port's int8 KV pages against the JAX package's.

`quantize_rows` and the int8 page writes must equal the JAX package's bit for
bit (int8 values and f32 scales), on f32 and bf16 inputs with zero rows. The
port's plain int8 paged attention (what its wrapper runs on CPU tensors) must
match the JAX Pallas kernels, pipelined and tiled, run in interpret mode, to
atol = rtol = 1e-5 in f32, at the flagship family's shapes and at every GQA
group and head dim the CUDA kernels take. Inputs come from seeded numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.ops.quantized_kv import (
    make_quantized_kv_pages as jax_make_pages,
    paged_attention_quantized as jax_paged_attention_quantized,
    quantize_rows as jax_quantize_rows,
    write_kv_pages_quantized as jax_write_quantized,
)
from llm_d_kv_cache_manager_tpu_torch.ops import quantized_kv as port_qkv
from llm_d_kv_cache_manager_tpu_torch.ops.paged_attention import paged_attention_reference

TOL = dict(atol=1e-5, rtol=1e-5)


def _rows(shape, seed, zero_rows=()):
    """Normal rows times 3, with whole rows zeroed (scale clamps to 1e-8)."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * 3
    for idx in zero_rows:
        x[idx] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bitwise(dtype):
    x = _rows((16, 4, 128), seed=0, zero_rows=[(0, 0), (5, 3), (15, 1)])
    want_q, want_s = jax_quantize_rows(jnp.asarray(x).astype(dtype))
    got_q, got_s = port_qkv.quantize_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert not got_q[0, 0].any() and float(got_s[0, 0]) == np.float32(1e-8)
    deq = port_qkv.dequantize_rows(got_q, got_s)
    assert torch.isfinite(deq).all()


@pytest.mark.parametrize("start_pos", [0, 14, 30])
def test_write_kv_pages_quantized_bitwise(start_pos):
    """The case of tests/test_quantized_kv.py::TestQuantizedWrites, at three
    start positions."""
    n_kv, n_pages, page, hd = 2, 8, 16, 32
    bt = np.array([3, 6, 1], np.int32)
    k_new = _rows((5, n_kv, hd), seed=2, zero_rows=[(1, 0)])
    v_new = k_new * 0.5
    want = jax_write_quantized(
        *jax_make_pages(n_kv, n_pages, page, hd), jnp.asarray(bt),
        jnp.asarray(k_new), jnp.asarray(v_new), start_pos,
    )
    pools = port_qkv.make_quantized_kv_pages(n_kv, n_pages, page, hd, device="cpu")
    got = port_qkv.write_kv_pages_quantized(
        *pools, torch.from_numpy(bt), torch.from_numpy(k_new),
        torch.from_numpy(v_new), start_pos,
    )
    assert all(g is p for g, p in zip(got, pools))  # updated in place
    for g, w in zip(pools, want):
        assert g.shape == w.shape and g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert pools[0].any()


def _quantized_inputs(batch=2, n_q=8, n_kv=4, hd=128, page=128, n_pages=12, pps=3):
    """The shapes of tests/test_quantized_kv.py::_setup, drawn from numpy and
    quantized by the JAX package: (q, k_q, k_scale, v_q, v_scale, tables)."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((batch, n_q, hd), dtype=np.float32)
    k = rng.standard_normal((n_kv, n_pages, page, hd), dtype=np.float32)
    v = rng.standard_normal((n_kv, n_pages, page, hd), dtype=np.float32)
    bt = rng.permutation(n_pages)[: batch * pps].reshape(batch, pps).astype(np.int32)
    kq, ks = jax_quantize_rows(jnp.asarray(k))
    vq, vs = jax_quantize_rows(jnp.asarray(v))
    return (q, np.array(kq), np.array(ks)[..., None], np.array(vq),
            np.array(vs)[..., None], bt)


# (seq_lens, window, n_q, page): tests/test_quantized_kv.py's lengths and the
# windows of tests/test_ops.py, with MHA and pages of 16 and 128.
ATTENTION_CASES = {
    "partial_pages": ([5, 300], None, 8, 128),
    "page_boundaries": ([128, 384], None, 8, 128),
    "empty_slot": ([0, 256], None, 8, 128),
    "unaligned": ([37, 290], None, 8, 128),
    "window_64": ([37, 300], 64, 8, 128),
    "window_128": ([37, 300], 128, 8, 128),
    "window_200": ([37, 300], 200, 8, 128),
    "mha": ([37, 290], None, 4, 128),
    "page_16": ([5, 300], None, 8, 16),
    "page_16_window": ([37, 290], 64, 8, 16),
}


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "tiled"])
@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_paged_attention_quantized_matches_jax_kernel(case, pipelined):
    seq_lens, window, n_q, page = ATTENTION_CASES[case]
    scale = 128 // page
    inputs = _quantized_inputs(n_q=n_q, page=page, n_pages=12 * scale, pps=3 * scale)
    lens = np.asarray(seq_lens, np.int32)
    want = jax_paged_attention_quantized(
        *(jnp.asarray(a) for a in inputs), jnp.asarray(lens),
        interpret=True, pipelined=pipelined, window=window,
    )
    tensors = [torch.from_numpy(a) for a in inputs]
    before = (port_qkv.launches, port_qkv.tiled_launches)
    got = port_qkv.paged_attention_quantized(
        *tensors, torch.from_numpy(lens), pipelined=pipelined, window=window,
    )
    plain = port_qkv.paged_attention_quantized_reference(
        *tensors, torch.from_numpy(lens), window=window,
    )
    assert torch.equal(got, plain)  # CPU tensors take the plain version
    assert (port_qkv.launches, port_qkv.tiled_launches) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if 0 in seq_lens:
        assert not got[lens == 0].any()


# (n_q, n_kv, hd, seq_lens, window) at page 16 over 6-page tables: the GQA
# groups and head dims the CUDA kernels take beyond the flagship family's, as
# tests/test_torch_ops.py's SHAPE_CASES, on int8 pages.
SHAPE_CASES = {
    "group_3": (6, 2, 128, [5, 90], None),
    "group_5": (10, 2, 128, [17, 96], None),
    "group_6_window": (12, 2, 128, [40, 96], 24),
    "group_7_qwen7b_heads": (28, 4, 128, [0, 77], None),
    "group_12_chunked_window": (12, 1, 128, [96, 50], 40),
    "group_13_partial_last_chunk": (26, 2, 128, [31, 96], None),
    "hd64_group_7_qwen05b_heads": (14, 2, 64, [1, 96], None),
    "hd64_group_7_window": (14, 2, 64, [70, 96], 30),
    "hd64_group_12_chunked": (12, 1, 64, [0, 64], None),
    "hd288_group_1": (2, 2, 288, [17, 96], None),
    "hd300_group_2_window": (4, 2, 300, [70, 96], 30),
    "hd512_group_2_empty_slot": (4, 2, 512, [0, 77], None),
    "hd576_group_8": (16, 2, 576, [31, 96], None),
}


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "tiled"])
@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_paged_attention_quantized_groups_and_head_dims(case, pipelined):
    n_q, n_kv, hd, seq_lens, window = SHAPE_CASES[case]
    inputs = _quantized_inputs(n_q=n_q, n_kv=n_kv, hd=hd, page=16, n_pages=14, pps=6)
    lens = np.asarray(seq_lens, np.int32)
    want = jax_paged_attention_quantized(
        *(jnp.asarray(a) for a in inputs), jnp.asarray(lens),
        interpret=True, pipelined=pipelined, window=window,
    )
    before = (port_qkv.launches, port_qkv.tiled_launches)
    got = port_qkv.paged_attention_quantized(
        *(torch.from_numpy(a) for a in inputs), torch.from_numpy(lens),
        pipelined=pipelined, window=window,
    )
    assert (port_qkv.launches, port_qkv.tiled_launches) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[lens == 0].any()


def test_quantized_reference_rounds_to_q_dtype():
    """The plain version rounds dequantized K/V to q's dtype, as the JAX
    reference does: a bf16 q gives the bf16-page result exactly."""
    q, kq, ks, vq, vs, bt = (torch.from_numpy(a) for a in _quantized_inputs())
    lens = torch.tensor([37, 290], dtype=torch.int32)
    qb = q.to(torch.bfloat16)
    got = port_qkv.paged_attention_quantized_reference(qb, kq, ks, vq, vs, bt, lens)
    k_pages = (kq.float() * ks).to(torch.bfloat16)
    v_pages = (vq.float() * vs).to(torch.bfloat16)
    want = paged_attention_reference(qb, k_pages, v_pages, bt, lens)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
