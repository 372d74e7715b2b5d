"""The tiled decode's second pass (the split-KV combine) and its plain versions.

`split_partials_reference` writes the workspace the tiled kernel's split pass
writes (its page ranges, empty splits m = -inf, l = 0) and
`combine_reference` merges it; together they must give
`paged_attention_reference`, and the JAX package's tiled kernels
(`pipelined=False`, Pallas in interpret mode) at the Qwen2.5 attention
shapes (group 7) at batch 1 over 32 splits' worth of pages, on f32 and int8
pages. f32 throughout, atol = rtol = 1e-5 (two orders of the same f32
sums); a `seq_len == 0` row gives exact zeros. Also on the CPU: the
workspace's layout and checks, `combine_splits` taking the plain version
for CPU tensors (no launch counted), and the combine's C source. Inputs come
from seeded numpy. The CUDA combine is held against `combine_reference` on
the card by chip_smoke.py's phase 3.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
)
from llm_d_kv_cache_manager_tpu.ops.quantized_kv import (
    paged_attention_quantized as jax_paged_attention_quantized,
    quantize_rows as jax_quantize_rows,
)
from llm_d_kv_cache_manager_tpu_torch.ops import paged_attention as port_paged
from llm_d_kv_cache_manager_tpu_torch.ops import quantized_kv as port_qkv

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 16
_CSRC = port_paged.__file__.rsplit("/", 2)[0] + "/csrc"


def _inputs(batch, n_q, n_kv, hd, width, seed=0):
    """(q, k, v, block_tables) in f32, tables of `width` pages of 16 over a
    shuffled pool."""
    rng = np.random.default_rng(seed)
    n_pages = batch * width + 3
    q = rng.standard_normal((batch, n_q, hd), dtype=np.float32)
    k = rng.standard_normal((n_kv, n_pages, PAGE, hd), dtype=np.float32)
    v = rng.standard_normal((n_kv, n_pages, PAGE, hd), dtype=np.float32)
    bt = rng.permutation(n_pages)[: batch * width].reshape(batch, width).astype(np.int32)
    return q, k, v, bt


def _assert_rows(got, want, lens):
    live = np.asarray(lens) > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert not np.any(got[~live])  # seq_len 0: exact zeros


# Lengths over 12-page tables (192 positions) at batch 4: an empty slot, a
# sequence inside its first page, one that leaves most splits empty, and a
# full table.
LENS = [0, 9, 40, 192]


@pytest.mark.parametrize("window", [None, 50], ids=["no_window", "window_50"])
@pytest.mark.parametrize("n_splits", [1, 5, 32])
@pytest.mark.parametrize("head_dim", [64, 100, 128, 512])
@pytest.mark.parametrize("group", [1, 2, 7, 16])
def test_split_partials_then_combine_is_paged_attention(group, head_dim, n_splits, window):
    """Any split count of the kernel's page ranges merges back to the whole
    attention; 32 splits of 12 pages leave splits empty in every row."""
    n_kv = 2
    q, k, v, bt = (torch.from_numpy(a) for a in _inputs(4, group * n_kv, n_kv, head_dim, 12))
    lens = torch.tensor(LENS, dtype=torch.int32)
    m, l, acc = port_paged.split_partials_reference(q, k, v, bt, lens, n_splits, window)
    n_chunks, rows = port_paged.group_chunks(group, head_dim, bf16_q=False)
    assert m.shape == l.shape == (4, n_kv * n_chunks, n_splits, rows)
    assert acc.shape == m.shape + (head_dim,)
    empty = torch.isinf(m)
    assert bool((l[empty] == 0).all()) and not acc[empty].any()
    assert bool(empty[0].all())  # the seq_len 0 row: every split empty
    if n_splits == 32:
        assert bool(empty[1].any())  # 9 tokens: one page, 31 empty splits
    got = port_paged.combine_reference(m, l, acc, group)
    want = port_paged.paged_attention_reference(q, k, v, bt, lens, window=window)
    _assert_rows(got.numpy(), want.numpy(), LENS)


@pytest.mark.parametrize("head_dim, group", [(576, 16), (1024, 3), (300, 8)])
def test_split_partials_take_the_wide_bodies_rows(head_dim, group):
    """bf16 q above head dim 512 runs the wide Hopper body's chunks (3 rows
    up to 768, 2 above; f32 q 4): both workspaces merge to the same rows."""
    q, k, v, bt = (torch.from_numpy(a) for a in _inputs(2, group, 1, head_dim, 12, seed=4))
    lens = torch.tensor([150, 33], dtype=torch.int32)
    want = port_paged.paged_attention_reference(q, k, v, bt, lens).numpy()
    for bf16_q in (False, True):
        ws = port_paged.split_partials_reference(q, k, v, bt, lens, 7, bf16_q=bf16_q)
        assert ws[0].shape[3] == port_paged.group_chunks(group, head_dim, bf16_q)[1]
        got = port_paged.combine_reference(*ws, group).numpy()
        np.testing.assert_allclose(got, want, **TOL)


# (n_q, n_kv, head_dim): the Qwen2.5-7B and -0.5B attention shapes (group 7).
QWEN = {"qwen2.5-7b": (28, 4, 128), "qwen2.5-0.5b": (14, 2, 64)}
# Batch 1 over a 64-page table: 1,000 tokens fill 63 pages, 2 a split over
# 32 splits, every split live; a window of 200 leaves 13 pages, one a split
# (19 splits empty).
QWEN_WIDTH, QWEN_LEN, N_SPLITS = 64, 1000, 32


@pytest.mark.parametrize("window", [None, 200], ids=["no_window", "window_200"])
@pytest.mark.parametrize("model", sorted(QWEN))
def test_tiled_rows_match_jax_tiled_kernel_at_qwen_shapes(model, window):
    """Row 3: the port's tiled entry (the plain version on CPU tensors) and
    the split-then-combine references over 32 splits equal the JAX
    package's `_decode_kernel` (pipelined=False) at group 7, batch 1."""
    n_q, n_kv, hd = QWEN[model]
    q, k, v, bt = _inputs(1, n_q, n_kv, hd, QWEN_WIDTH, seed=7)
    lens = np.array([QWEN_LEN], np.int32)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), jnp.asarray(lens),
        interpret=True, pipelined=False, window=window))
    tq, tk, tv, tbt, tlens = (torch.from_numpy(a) for a in (q, k, v, bt, lens))
    before = (port_paged.tiled_launches, port_paged.combine_launches)
    got = port_paged.paged_attention(tq, tk, tv, tbt, tlens, pipelined=False, window=window)
    assert (port_paged.tiled_launches, port_paged.combine_launches) == before
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ws = port_paged.split_partials_reference(tq, tk, tv, tbt, tlens, N_SPLITS, window)
    assert int((~torch.isinf(ws[0][0, 0, :, 0])).sum()) == (N_SPLITS if window is None else 13)
    merged = port_paged.combine_splits(*ws, n_q // n_kv)
    np.testing.assert_allclose(merged.numpy(), want, **TOL)


@pytest.mark.parametrize("window", [None, 200], ids=["no_window", "window_200"])
@pytest.mark.parametrize("model", sorted(QWEN))
def test_tiled_int8_rows_match_jax_tiled_kernel_at_qwen_shapes(model, window):
    """Row 4: the same on int8 pages (quantized by the JAX package), against
    `paged_attention_quantized(pipelined=False)`; the references run on the
    dequantized pages."""
    n_q, n_kv, hd = QWEN[model]
    q, k, v, bt = _inputs(1, n_q, n_kv, hd, QWEN_WIDTH, seed=8)
    kq, ks = (np.array(a) for a in jax_quantize_rows(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jax_quantize_rows(jnp.asarray(v)))
    pools = (kq, ks[..., None], vq, vs[..., None])
    lens = np.array([QWEN_LEN], np.int32)
    want = np.asarray(jax_paged_attention_quantized(
        jnp.asarray(q), *(jnp.asarray(a) for a in pools), jnp.asarray(bt), jnp.asarray(lens),
        interpret=True, pipelined=False, window=window))
    tq, tbt, tlens = (torch.from_numpy(a) for a in (q, bt, lens))
    tpools = [torch.from_numpy(a) for a in pools]
    before = (port_qkv.tiled_launches, port_paged.combine_launches)
    got = port_qkv.paged_attention_quantized(tq, *tpools, tbt, tlens, pipelined=False,
                                             window=window)
    assert (port_qkv.tiled_launches, port_paged.combine_launches) == before
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    k_deq = port_qkv.dequantize_rows(tpools[0], tpools[1][..., 0])
    v_deq = port_qkv.dequantize_rows(tpools[2], tpools[3][..., 0])
    ws = port_paged.split_partials_reference(tq, k_deq, v_deq, tbt, tlens, N_SPLITS, window)
    np.testing.assert_allclose(port_paged.combine_reference(*ws, n_q // n_kv).numpy(), want,
                               **TOL)


def test_combine_reference_edge_rows():
    """An all-empty row gives zeros; a split of m = -inf never contributes,
    whatever its acc holds; the largest m's split alone gives its acc / l."""
    m = torch.tensor([[[[-np.inf, 0.5], [-np.inf, -np.inf], [-np.inf, 3.0]]]])  # [1, 1, 3, 2]
    l = torch.tensor([[[[0.0, 2.0], [0.0, 0.0], [0.0, 4.0]]]])
    acc = torch.full((1, 1, 3, 2, 4), float("nan"))
    acc[0, 0, 0, 1] = 1.0
    acc[0, 0, 2, 1] = torch.arange(4.0)
    out = port_paged.combine_reference(m, l, acc, group=2)
    assert torch.equal(out[0, 0], torch.zeros(4))
    w = np.exp(np.float32(0.5 - 3.0))
    want = (w * np.ones(4, np.float32) + np.arange(4, dtype=np.float32)) / (w * 2 + 4)
    np.testing.assert_allclose(out[0, 1].numpy(), want, **TOL)
    assert port_paged.combine_reference(m, l, acc, 2, torch.bfloat16).dtype == torch.bfloat16


def test_combine_splits_on_cpu_takes_the_plain_version():
    q, k, v, bt = (torch.from_numpy(a) for a in _inputs(2, 14, 2, 64, 12, seed=2))
    lens = torch.tensor([0, 150], dtype=torch.int32)
    ws = port_paged.split_partials_reference(q, k, v, bt, lens, 5)
    before = port_paged.combine_launches
    for dtype in (torch.float32, torch.bfloat16):
        got = port_paged.combine_splits(*ws, 7, dtype)
        assert got.dtype == dtype and torch.equal(
            got, port_paged.combine_reference(*ws, 7, dtype))
    assert port_paged.combine_launches == before
    with pytest.raises(ValueError, match="workspace"):
        port_paged.combine_splits(ws[0][:, :1], ws[1], ws[2], 7)
    with pytest.raises(TypeError, match="f32"):
        port_paged.combine_splits(ws[0].double(), ws[1], ws[2], 7)


# (n_q, n_kv, head_dim, q dtype, table width, the plan that sizes its
# splits): decode_plan's shapes at the flagship's, the Qwen2.5 pair's (f32
# q up to head_dim 256 runs the Hopper body and takes decode_plan at its f32
# stage) and the wide bodies', old_body_splits' at f32 q above 256.
WORKSPACE_CASES = {
    "flagship_b8_bf16": (16, 8, 128, torch.bfloat16, 128, "decode_plan"),
    "qwen7b_b1_bf16": (28, 4, 128, torch.bfloat16, 128, "decode_plan"),
    "qwen05b_b1_f32": (14, 2, 64, torch.float32, 128, "decode_plan"),
    "hd576_group16_bf16": (16, 1, 576, torch.bfloat16, 128, "decode_plan"),
    "hd576_group16_f32": (16, 1, 576, torch.float32, 128, "old_body_splits"),
    "hd50_odd_rows": (3, 1, 50, torch.bfloat16, 5, "decode_plan"),
}


@pytest.mark.parametrize("case", sorted(WORKSPACE_CASES))
def test_decode_workspace_layout(case, monkeypatch):
    """The workspace holds `_plan`'s split count and group_chunks' rows for
    q's dtype, acc first (16-byte aligned rows for the combine's float4
    loads), m and l after it; launch_decode refuses one of another shape
    before it builds or launches anything."""
    monkeypatch.setattr(port_paged, "_sm_count", lambda device: 132)
    n_q, n_kv, hd, dtype, width, plan = WORKSPACE_CASES[case]
    batch = 8 if case.endswith("b8_bf16") else 1
    q = torch.zeros(batch, n_q, hd, dtype=dtype)
    k = torch.zeros(n_kv, batch * width, PAGE, hd, dtype=dtype)
    bt = torch.zeros(batch, width, dtype=torch.int32)
    m, l, acc = port_paged.decode_workspace(q, k, bt)
    bf16 = dtype == torch.bfloat16
    n_chunks, rows = port_paged.group_chunks(n_q // n_kv, hd, bf16)
    _, n_splits = port_paged._plan(132, dtype, batch, n_kv, width, PAGE, n_q // n_kv, hd)
    if plan == "decode_plan":
        assert n_splits == port_paged.decode_plan(batch, n_kv, width, PAGE, 132, n_q // n_kv, hd,
                                                  page_dtype=dtype)[1]
    else:
        assert n_splits == port_paged.old_body_splits(batch, n_kv, width, 132, n_q // n_kv, hd)
    assert m.shape == l.shape == (batch, n_kv * n_chunks, n_splits, rows)
    assert acc.shape == m.shape + (hd,)
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in (m, l, acc))
    base = acc.untyped_storage().data_ptr()
    assert acc.data_ptr() == base and acc.data_ptr() % 16 == 0
    assert m.data_ptr() == base + acc.numel() * 4 and l.data_ptr() == m.data_ptr() + m.numel() * 4
    lens = torch.ones(batch, dtype=torch.int32)
    wrong = (m[:, :, :1].contiguous(), l[:, :, :1].contiguous(), acc[:, :, :1].contiguous())
    if n_splits > 1:
        with pytest.raises(ValueError, match="workspace"):
            port_paged.launch_decode(q, k, k, bt, lens, None, pipelined=False, workspace=wrong)


def test_combine_source_has_no_atomics_and_one_entry():
    """The combine sums in a fixed order (no atomics), and the C entry that
    runs it alone is declared once, in paged_decode_tiled.cu."""
    body = open(f"{_CSRC}/paged_decode_combine.cuh").read()
    assert not re.search(r"\batomic\w*\s*\(", body) and "combine_kernel" in body
    tiled = open(f"{_CSRC}/paged_decode_tiled.cu").read()
    wide = open(f"{_CSRC}/paged_decode_wide.cu").read()
    assert tiled.count('extern "C" int kvt_paged_decode_combine(') == 1
    assert "kvt_paged_decode_combine" not in wide
    for text in (tiled, wide):
        assert '#include "paged_decode_combine.cuh"' in text
        assert "combine_wide_kernel" not in text and "combine::launch" in text
