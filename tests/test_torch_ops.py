"""The port's attention ops against the JAX package's kernels.

Inputs come from seeded numpy and go through both packages; the JAX Pallas
kernels run in interpret mode on the CPU, as the JAX package's own tests run
them. On CPU tensors the port's wrappers run their plain torch versions
(the CUDA kernels are held against those same versions on the card by
chip_smoke.py). f32 throughout; tolerance atol = rtol = 1e-5. The shapes
run through GQA groups and head dims the CUDA kernels take (groups of 3 to
7, groups above 8 that run in chunks, 71 and 128 over one kv head; head_dim
64 beside 128, and 50, 80, 96, 100 and 256, which the kernels run at padded
widths; 288, 300, 512 and 576, which they run in column slabs of 256; the
Qwen2.5, OpenLLaMA-3B and Gemma-7B attention shapes). Also on the CPU: the
decode kernels' launch plan (by q's dtype, GQA group and head dim), the
ctypes argument lists against the C entry points they call, and that every
head dim passes the kernels' checks.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.ops.flash_prefill import flash_prefill as jax_flash_prefill
from llm_d_kv_cache_manager_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    write_kv_pages as jax_write_kv_pages,
)
from llm_d_kv_cache_manager_tpu_torch.ops import flash_prefill as port_flash
from llm_d_kv_cache_manager_tpu_torch.ops import paged_attention as port_paged

TOL = dict(atol=1e-5, rtol=1e-5)


def _paged_inputs(batch=2, n_q=8, n_kv=4, head_dim=128, page_size=128,
                  n_pages=12, pps=3, seed=0):
    """The shapes of tests/test_ops.py::_setup, drawn from numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, n_q, head_dim), dtype=np.float32)
    k = rng.standard_normal((n_kv, n_pages, page_size, head_dim), dtype=np.float32)
    v = rng.standard_normal((n_kv, n_pages, page_size, head_dim), dtype=np.float32)
    bt = rng.permutation(n_pages)[: batch * pps].reshape(batch, pps).astype(np.int32)
    return q, k, v, bt


def _both_paged(inputs, seq_lens, window=None, pipelined=True):
    q, k, v, bt = inputs
    lens = np.asarray(seq_lens, np.int32)
    want = jax_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(lens), interpret=True, pipelined=pipelined, window=window,
    )
    got = port_paged.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bt), torch.from_numpy(lens), pipelined=pipelined,
        window=window,
    )
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("seq_lens", [[1, 300], [128, 384], [0, 256]])
def test_paged_attention_matches_pipelined_kernel(seq_lens):
    want, got = _both_paged(_paged_inputs(), seq_lens)
    live = np.asarray(seq_lens) > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    # seq_len == 0 slots: zeros in both (the JAX plain reference gives NaN).
    assert not np.any(got[~live]) and not np.any(want[~live])


def test_paged_attention_mha():
    want, got = _both_paged(_paged_inputs(n_q=4, n_kv=4), [37, 290])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("window", [64, 128, 200])
def test_paged_attention_sliding_window(window):
    inputs = _paged_inputs()
    want, got = _both_paged(inputs, [37, 300], window=window)
    np.testing.assert_allclose(got, want, **TOL)
    _, full = _both_paged(inputs, [37, 300])
    assert np.max(np.abs(got - full)) > 1e-3  # the window is load-bearing


@pytest.mark.parametrize("pps", [1, 2])
def test_paged_attention_narrow_table(pps):
    want, got = _both_paged(_paged_inputs(pps=pps), [1, pps * 128])
    np.testing.assert_allclose(got, want, **TOL)


# (n_q, n_kv, head_dim, seq_lens, window) at page 16 over 6-page tables: the
# groups and head dims the kernels take beyond the flagship family's (3-7 in
# one CTA; 12 in two chunks of 6, 13 in 7 + 6, 71 in 9 x 8, 128 in 16 x 8;
# head_dim 64, and 50, 80, 96, 100 and 256 off the built widths), the two
# Qwen2.5 attention shapes (28/4 of 128, 14/2 of 64: group 7), OpenLLaMA-3B's
# (32/32 of 100), Gemma-7B's (16/16 of 256), Falcon-7B's (71/1 of 64), an
# empty slot and windows; and head dims above 256, which the kernels cut
# into column slabs of 256 (288 and 300: a second slab of 32 and 44
# columns, 300's bf16 rows only 8-byte aligned; 512; 576, DeepSeek-V2/V3's
# absorbed MLA width) at groups 1, 2 and 8 (two chunks of 4).
SHAPE_CASES = {
    "group_3": (6, 2, 128, [5, 90], None),
    "group_5": (10, 2, 128, [17, 96], None),
    "group_6_window": (12, 2, 128, [40, 96], 24),
    "group_7_qwen7b_heads": (28, 4, 128, [0, 77], None),
    "group_12_chunked": (24, 2, 128, [33, 96], None),
    "group_12_chunked_window": (12, 1, 128, [96, 50], 40),
    "group_13_partial_last_chunk": (26, 2, 128, [31, 96], None),
    "hd64_group_1": (2, 2, 64, [16, 81], None),
    "hd64_group_7_qwen05b_heads": (14, 2, 64, [1, 96], None),
    "hd64_group_7_window": (14, 2, 64, [70, 96], 30),
    "hd64_group_12_chunked": (12, 1, 64, [0, 64], None),
    "hd50": (4, 2, 50, [5, 90], None),
    "hd50_window": (4, 2, 50, [70, 96], 30),
    "hd80": (8, 4, 80, [17, 96], None),
    "hd96_window": (8, 2, 96, [40, 96], 24),
    "hd100_openllama3b_heads": (32, 32, 100, [0, 77], None),
    "hd100_group_4": (16, 4, 100, [33, 96], None),
    "hd256_gemma7b_heads": (16, 16, 256, [31, 96], None),
    "hd256_group_8_window": (8, 1, 256, [96, 50], 40),
    "group_71_falcon7b_heads": (71, 1, 64, [17, 96], None),
    "group_128": (128, 1, 128, [1, 96], 50),
    "hd288_group_1": (2, 2, 288, [17, 96], None),
    "hd300_group_2_window": (4, 2, 300, [70, 96], 30),
    "hd512_group_2_empty_slot": (4, 2, 512, [0, 77], None),
    "hd512_group_8_chunked": (8, 1, 512, [33, 96], None),
    "hd576_group_1_window": (2, 2, 576, [96, 50], 40),
    "hd576_group_8": (16, 2, 576, [31, 96], None),
}


@pytest.mark.parametrize("pipelined", [True, False], ids=["pipelined", "tiled"])
@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_paged_attention_groups_and_head_dims(case, pipelined):
    n_q, n_kv, hd, seq_lens, window = SHAPE_CASES[case]
    inputs = _paged_inputs(n_q=n_q, n_kv=n_kv, head_dim=hd, page_size=16, n_pages=14,
                           pps=6, seed=3)
    before = (port_paged.launches, port_paged.tiled_launches)
    want, got = _both_paged(inputs, seq_lens, window=window, pipelined=pipelined)
    live = np.asarray(seq_lens) > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert not np.any(got[~live])
    assert (port_paged.launches, port_paged.tiled_launches) == before


# (seq_lens, window, n_q, page): the pipelined cases above, on the tiled
# entry point (JAX `_decode_kernel` on a (seq, head, page) grid).
TILED_CASES = {
    "partial_pages": ([1, 300], None, 8, 128),
    "page_boundaries": ([128, 384], None, 8, 128),
    "empty_slot": ([0, 256], None, 8, 128),
    "mha": ([37, 290], None, 4, 128),
    "window_64": ([37, 300], 64, 8, 128),
    "window_200": ([37, 300], 200, 8, 128),
    "page_16": ([5, 300], None, 8, 16),
}


@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_paged_attention_tiled_matches_tiled_kernel(case):
    seq_lens, window, n_q, page = TILED_CASES[case]
    scale = 128 // page
    inputs = _paged_inputs(n_q=n_q, page_size=page, n_pages=12 * scale, pps=3 * scale)
    before = port_paged.tiled_launches
    want, got = _both_paged(inputs, seq_lens, window=window, pipelined=False)
    np.testing.assert_allclose(got, want, **TOL)
    assert port_paged.tiled_launches == before


# (batch, n_kv, table_width, page_size, n_sms): the flagship's decode shapes
# on an H100's 132 SMs, the pod's padded tables, narrow tables and page 128.
PLAN_CASES = {
    "serving_b1_table128": (1, 8, 128, 16, 132),
    "b2_ctx2048": (2, 8, 128, 16, 132),
    "b1_ctx4096": (1, 8, 256, 16, 132),
    "b8_ctx2048": (8, 8, 128, 16, 132),
    "b8_trash_padded": (8, 8, 129, 16, 132),
    "narrow_width1": (1, 8, 1, 16, 132),
    "narrow_width2": (1, 8, 2, 16, 132),
    "narrow_width2_b8": (8, 8, 2, 16, 132),
    "page128_b1": (1, 8, 16, 128, 132),
    "page128_width1": (1, 8, 1, 128, 132),
    "page128_b8": (8, 8, 16, 128, 132),
    "large_batch": (64, 8, 256, 16, 132),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_decode_plan(case):
    batch, n_kv, width, page, n_sms = PLAN_CASES[case]
    cluster, n_splits = port_paged.decode_plan(batch, n_kv, width, page, n_sms)
    # Neither split exceeds the table's pages.
    assert 1 <= n_splits <= width and 1 <= cluster <= width
    # The cluster is a power of two no larger than the split and the
    # portable 8, so it divides the pipelined kernel's grid (cluster x n_kv x
    # batch, the cluster along x) and head_dim 128 (each rank merges an
    # equal slice of the columns).
    assert cluster & (cluster - 1) == 0 and cluster <= n_splits
    assert 128 % cluster == 0 and cluster <= 8
    # At most one CTA per SM once the pairs alone do not fill the card.
    if batch * n_kv < n_sms:
        assert batch * n_kv * max(cluster, n_splits) <= n_sms
    # Batch 1 x 8 kv heads fills the card where the table allows it.
    if batch == 1 and n_kv == 8 and width * page >= 16 * 64:
        assert batch * n_kv * cluster >= 64 and batch * n_kv * n_splits >= 64


@pytest.mark.parametrize("batch, width, want",
                         [(8, 129, 5), (1, 128, 33), (1, 2, 2), (64, 256, 1)])
def test_old_body_splits_keep_two_ctas_per_sm(batch, width, want):
    """f32 q above head_dim 256 (on f32 or int8 pages, the first wide
    body) keeps the first port's split rule (about two CTAs per SM over the
    tuples; at one slab, as here, those of head_dim 128)."""
    assert port_paged.old_body_splits(batch, 8, width, 132) == want


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("int8", [False, True], ids=["q_pages", "int8_pages"])
@pytest.mark.parametrize("hd", [64, 100, 128, 256])
def test_launch_plan_follows_q_dtype(case, q_dtype, int8, hd):
    """Up to head_dim 256 bf16 q and f32 q run the Hopper body on pages of
    their dtype and on int8 pages alike and take decode_plan, its splits
    capped at the page format's ring stages: 64 tokens, but 32 on f32 pages
    at the padded widths 128 and 256."""
    batch, n_kv, width, page, n_sms = PLAN_CASES[case]
    got = port_paged._plan(n_sms, q_dtype, batch, n_kv, width, page, head_dim=hd, int8=int8)
    page_dtype = torch.int8 if int8 else q_dtype
    assert got == port_paged.decode_plan(batch, n_kv, width, page, n_sms, head_dim=hd,
                                         page_dtype=page_dtype)
    stage = 32 if page_dtype == torch.float32 and hd > 64 else 64
    assert port_paged.stage_tokens(hd, page_dtype) == stage
    cluster, n_splits = got
    assert 1 <= cluster <= n_splits <= max(1, min(width, width * page // stage))


_CTYPE = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
_CSRC = Path(port_paged.__file__).resolve().parent.parent / "csrc"


# (batch, n_kv, table_width, page_size, n_sms, group, head_dim): the Qwen2.5
# attention shapes at the pods' decode shapes (group 7 over 4 and 2 kv
# heads, head_dim 128 and 64), and groups that run in chunks: 12 over 8 kv
# heads (Mistral-Large's 96/8) and the largest, 64 over one.
GROUP_PLAN_CASES = {
    "qwen7b_serving_b1": (1, 4, 128, 16, 132, 7, 128),
    "qwen7b_b8_trash_padded": (8, 4, 129, 16, 132, 7, 128),
    "qwen05b_serving_b1": (1, 2, 128, 16, 132, 7, 64),
    "qwen05b_b8": (8, 2, 129, 16, 132, 7, 64),
    "chunked_group12_b1": (1, 8, 128, 16, 132, 12, 128),
    "chunked_group12_b8": (8, 8, 129, 16, 132, 12, 128),
    "chunked_group12_hd64_narrow": (2, 8, 2, 16, 132, 12, 64),
    "chunked_group64_b1": (1, 1, 256, 16, 132, 64, 128),
}


# (batch, n_kv, table_width, group, head_dim): head dims above 256 at phase
# 21's shape (4/2 heads of 512: the flagship's width regrouped) at its
# decode shapes, wider heads and groups in chunks, every head dim above 256
# of chip_smoke.py's WIDE_SHAPES at batch 1 and 8 over a 2,048-token table
# (`WIDE_PLAN_SHAPES`), and head dims above 1,024, which bf16 q runs in the
# first wide body's slabs (`BEYOND_PLAN_SHAPES` among them).
WIDE_PLAN_SHAPES = {  # chip_smoke.WIDE_SHAPES above 256: (n_q, n_kv, head_dim)
    "hd=257": (4, 2, 257), "hd=288": (2, 2, 288), "hd=300 group=8": (8, 1, 300),
    "hd=320": (4, 2, 320), "hd=384 group=3": (6, 2, 384), "flagship-heads-512": (4, 2, 512),
    "hd=576 group=16": (16, 1, 576), "hd=1024": (2, 1, 1024),
}
# chip_smoke.BEYOND_SHAPES: head dims past any model, 1,280 at group 8 and
# 2,304 (flash: 9 panels, past the cluster kernel's 8).
BEYOND_PLAN_SHAPES = {"hd=1280 group=8": (8, 1, 1280), "hd=2304 group=2": (4, 2, 2304)}
SLAB_PLAN_CASES = {
    "hd512_b8": (8, 2, 129, 2, 512),
    "hd512_serving_b1": (1, 2, 128, 2, 512),
    "hd288_group8_b1": (1, 2, 128, 8, 288),
    "hd576_b2": (2, 4, 256, 1, 576),
    "hd1024_b1_narrow": (1, 1, 2, 2, 1024),
    "hd1280_slabs_b1": (1, 2, 128, 2, 1280),
    "hd2048_slabs_b8": (8, 1, 128, 1, 2048),
    **{f"{name} B={b}": (b, n_kv, 128, n_q // n_kv, hd)
       for name, (n_q, n_kv, hd) in {**WIDE_PLAN_SHAPES, **BEYOND_PLAN_SHAPES}.items()
       for b in (1, 8)},
}


def test_wide_plan_shapes_are_the_smokes():
    import chip_smoke

    assert WIDE_PLAN_SHAPES == {k: v for k, v in chip_smoke.WIDE_SHAPES.items() if v[2] > 256}
    assert BEYOND_PLAN_SHAPES == chip_smoke.BEYOND_SHAPES


@pytest.mark.parametrize("case", sorted(SLAB_PLAN_CASES))
def test_decode_plan_counts_slabs(case):
    """bf16 q up to head_dim 1,024 runs the wide Hopper body, one CTA (or
    cluster) for every column: the plan counts no slabs, and its cluster (up
    to the non-portable 16) divides the body's 512, 768 or 1,024 columns.
    Above 1,024 each column slab of 256 is a CTA (or cluster) of its own, at
    most the portable 8. f32 q keeps the slabs at every head dim above 256.
    Up to 256 there is one slab."""
    batch, n_kv, width, group, hd = SLAB_PLAN_CASES[case]
    assert [port_paged.n_slabs(d) for d in (1, 128, 256, 257, 512, 576, 1024)] == [
        1, 1, 1, 2, 2, 3, 4]
    assert [port_paged.hopper_slabs(d) for d in (1, 256, 257, 512, 576, 1024, 1025, 2048)] == [
        1, 1, 1, 1, 1, 1, 5, 8]
    assert [port_paged.max_cluster(d) for d in (128, 256, 257, 1024, 1025)] == [8, 8, 16, 16, 8]
    n_chunks, rows = port_paged.group_chunks(group, hd)
    assert rows <= port_paged.max_rows(hd) and (n_chunks - 1) * rows < group <= n_chunks * rows
    tuples = batch * n_kv * n_chunks * port_paged.hopper_slabs(hd)
    cluster, n_splits = port_paged.decode_plan(batch, n_kv, width, 16, 132, group, hd)
    assert 1 <= cluster <= n_splits <= width
    assert cluster & (cluster - 1) == 0 and cluster <= port_paged.max_cluster(hd)
    # Each rank merges an equal slice of the columns a CTA holds.
    cols = 256 * port_paged.n_slabs(hd) if hd <= 1024 else 256
    assert cols % cluster == 0 and (cols // cluster) % 4 == 0
    if tuples < 132:
        assert tuples * max(cluster, n_splits) <= 132
    assert port_paged._plan(132, torch.bfloat16, batch, n_kv, width, 16, group, hd) == (
        cluster, n_splits)
    # With the card's residency, every cluster of the launch fits at once:
    # the cluster shrinks (never the split count) until the pairs fit.
    for resident in ({2: 66, 4: 32, 8: 15, 16: 7}, {2: 66, 4: 33, 8: 16, 16: 8}, {}):
        c, n = port_paged.decode_plan(batch, n_kv, width, 16, 132, group, hd, resident)
        assert n == n_splits and c <= cluster and c & (c - 1) == 0
        assert c == 1 or tuples <= resident[c]
        assert 2 * c > min(cluster, n_splits) or tuples > resident.get(2 * c, 0)
    f32_tuples = batch * n_kv * port_paged.group_chunks(group, hd, False)[0] * \
        port_paged.n_slabs(hd)
    splits32 = port_paged.old_body_splits(batch, n_kv, width, 132, group, hd)
    assert 1 <= splits32 <= width and (splits32 == 1 or f32_tuples * (splits32 - 1) < 2 * 132)
    assert port_paged._plan(132, torch.float32, batch, n_kv, width, 16, group, hd) == (
        1, splits32)
    # One slab: the plans of a head dim up to 256 are those of 128.
    assert port_paged.decode_plan(batch, n_kv, width, 16, 132, group, 256) == \
        port_paged.decode_plan(batch, n_kv, width, 16, 132, group, 200)


@pytest.mark.parametrize("case", sorted(GROUP_PLAN_CASES))
def test_decode_plan_counts_group_chunks(case):
    batch, n_kv, width, page, n_sms, group, hd = GROUP_PLAN_CASES[case]
    n_chunks, rows = port_paged.group_chunks(group)
    triples = batch * n_kv * n_chunks  # CTAs (or clusters) before splitting
    cluster, n_splits = port_paged.decode_plan(batch, n_kv, width, page, n_sms, group)
    assert 1 <= cluster <= n_splits <= width
    assert cluster & (cluster - 1) == 0 and cluster <= 8
    # Each rank of the cluster merges an equal slice of the head dim.
    assert hd % cluster == 0 and (hd // cluster) % 4 == 0
    # Split no further than one CTA per SM, counting the chunk axis.
    if triples < n_sms:
        assert triples * max(cluster, n_splits) <= n_sms
    assert port_paged._plan(n_sms, torch.bfloat16, batch, n_kv, width, page, group,
                            head_dim=hd) == port_paged.decode_plan(batch, n_kv, width, page,
                                                                   n_sms, group, hd)
    # f32 q takes the same plan at its own stage: the chunks are bf16 q's
    # up to head_dim 256, and 32-token stages on f32 pages at 128.
    assert port_paged.group_chunks(group, hd, False) == port_paged.group_chunks(group, hd)
    for int8 in (False, True):
        page_dtype = torch.int8 if int8 else torch.float32
        c32, n32 = port_paged.decode_plan(batch, n_kv, width, page, n_sms, group, hd,
                                          page_dtype=page_dtype)
        assert port_paged._plan(n_sms, torch.float32, batch, n_kv, width, page, group,
                                head_dim=hd, int8=int8) == (c32, n32)
        assert 1 <= c32 <= n32 <= width and c32 & (c32 - 1) == 0 and c32 <= 8
        if triples < n_sms:
            assert triples * max(c32, n32) <= n_sms


def test_group_chunks_cover_every_group():
    """Groups up to 8 run whole; a larger one in ceil(group / 8) chunks of
    equal rows, at most 8, the last chunk not empty (so the kernels' chunk
    count ceil(group / rows) is the same). Above head_dim 128 a CTA holds 4
    rows, but the wide Hopper body (bf16 q, head_dim 257 to 1,024) 3 up to
    768 and 2 above (its lane holds 24 and 32 columns there); f32 q, and
    bf16 q above 1,024, keep 4 (the first wide body)."""
    assert [port_paged.group_chunks(g) for g in (1, 7, 8, 12, 13, 16, 64, 71, 128)] == [
        (1, 1), (1, 7), (1, 8), (2, 6), (2, 7), (2, 8), (8, 8), (9, 8), (16, 8)]
    four = [(1, 1), (1, 4), (2, 3), (2, 4), (4, 4)]
    for head_dims, bf16_q, want in (
            ((256, 288, 512), True, four),
            ((576, 768), True, [(1, 1), (2, 2), (2, 3), (3, 3), (6, 3)]),
            ((1024,), True, [(1, 1), (2, 2), (3, 2), (4, 2), (8, 2)]),
            ((1025, 2048), True, four), ((576, 1024, 2048), False, four)):
        for head_dim in head_dims:
            assert [port_paged.group_chunks(g, head_dim, bf16_q)
                    for g in (1, 4, 5, 8, 16)] == want
    for head_dim, bf16_q, limit in (
            (64, True, 8), (100, True, 8), (128, True, 8), (200, True, 4), (256, True, 4),
            (257, True, 4), (300, True, 4), (512, True, 4), (576, True, 3), (768, True, 3),
            (1024, True, 2), (1280, True, 4), (4096, True, 4), (128, False, 8),
            (576, False, 4), (1024, False, 4), (4096, False, 4)):
        for group in range(1, 257):
            n_chunks, rows = port_paged.group_chunks(group, head_dim, bf16_q)
            assert rows <= limit and n_chunks == -(-group // limit)
            assert (n_chunks - 1) * rows < group <= n_chunks * rows
            assert -(-group // rows) == n_chunks


def _kernel_args(n_q, n_kv, hd, dtype=torch.bfloat16):
    q, k, v, bt = (torch.from_numpy(a) for a in _paged_inputs(
        batch=1, n_q=n_q, n_kv=n_kv, head_dim=hd, page_size=16, n_pages=4, pps=2))
    return (q.to(dtype), k.to(dtype), v.to(dtype), bt, torch.tensor([20], dtype=torch.int32))


@pytest.mark.parametrize("n_q, n_kv, hd", [(6, 2, 96), (130, 2, 128), (65, 1, 64),
                                           (4, 2, 256), (4, 2, 288), (2, 1, 512)])
def test_decode_kernel_check_takes_every_head_dim(n_q, n_kv, hd):
    """Every head_dim and every GQA group pass the decode kernels' check on
    both page formats: up to 256 at padded widths, above it in column slabs
    (these shapes were owed until the kernels took them)."""
    args = _kernel_args(n_q, n_kv, hd)
    port_paged._check_kernel_args(*args, None)
    k8 = torch.zeros(args[1].shape, dtype=torch.int8)
    scale = torch.ones(*args[1].shape[:3], 1)
    port_paged._check_kernel_args(args[0], k8, k8, *args[3:], (scale, scale))


@pytest.mark.parametrize("n_q, n_kv, hd", [(28, 4, 128), (14, 2, 64), (24, 2, 128),
                                           (64, 1, 64), (8, 8, 64), (32, 32, 100), (4, 2, 50),
                                           (71, 1, 64), (16, 16, 256), (3, 1, 17)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_check_takes_new_shapes(n_q, n_kv, hd, dtype):
    port_paged._check_kernel_args(*_kernel_args(n_q, n_kv, hd, dtype), None)


class _NoLaunch(Exception):
    pass


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_q, n_kv, hd", [(6, 2, 96), (130, 2, 128), (4, 2, 288),
                                           (2, 1, 512)])
def test_flash_kernel_check_reaches_launch_at_every_head_dim(n_q, n_kv, hd, dtype,
                                                             monkeypatch):
    """Every head_dim and every GQA group pass the flash kernel's checks and
    reach its launch (stopped here: the CPU has no kernel)."""
    def stop():
        raise _NoLaunch

    monkeypatch.setattr(port_flash, "_kernel", stop)
    q = torch.zeros(1, 16, n_q, hd, dtype=dtype)
    k = torch.zeros(1, 16, n_kv, hd, dtype=dtype)
    with pytest.raises(_NoLaunch):
        port_flash._launch(q, k, k, 0, None)


def _c_signatures() -> dict:
    """Every `extern "C" int kvt_*` entry point of csrc/*.cu: name -> the
    ctypes kind of each parameter."""
    sigs = {}
    for path in sorted(_CSRC.glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" int (kvt_\w+)\(([^)]*)\)', path.read_text()):
            kinds = []
            for param in params.split(","):
                decl = " ".join(param.split())
                kind = "ptr" if "*" in decl else decl.rsplit(" ", 1)[0].replace("const ", "")
                kinds.append(_CTYPE[kind])
            sigs[name] = kinds
    return sigs


@pytest.mark.parametrize("fn_name", ["kvt_flash_prefill", "kvt_paged_decode",
                                     "kvt_paged_decode_tiled", "kvt_paged_decode_wide",
                                     "kvt_paged_decode_wide_tiled",
                                     "kvt_paged_decode_wide_resident",
                                     "kvt_paged_decode_combine"])
def test_ctypes_argtypes_match_c_signatures(fn_name):
    """A ctypes argument list that disagrees with the C entry point cuts
    pointers or shifts arguments silently on the card."""
    sigs = _c_signatures()
    assert sorted(sigs) == sorted({**port_paged._ARGTYPES, **port_flash._ARGTYPES})
    assert sigs[fn_name] == {**port_paged._ARGTYPES, **port_flash._ARGTYPES}[fn_name]


def test_every_decode_up_to_256_runs_the_hopper_body():
    """No instantiation of the first port's decode body remains, f32 q's
    included: paged_decode_common.cuh keeps only the shared helpers, both
    decode sources launch the Hopper body's kernels for every (q dtype, page
    format), and kvt_paged_decode takes a cluster whatever q's dtype."""
    common = (_CSRC / "paged_decode_common.cuh").read_text()
    assert not re.search(r"\b(attend_range|DecodeSmem)\b", common)
    for name, kernel, dispatch in (
            ("paged_decode", "paged_decode_cluster_kernel", "dispatch_cluster"),
            ("paged_decode_tiled", "split_decode_sm90_kernel", "dispatch_sm90")):
        src = (_CSRC / f"{name}.cu").read_text()
        assert not re.search(r"\b(paged_decode_kernel|split_decode_kernel)\b", src)
        assert "sm90::attend_range<TQ, TKV, HD, ROWS, BULK>(" in src
        assert f"{kernel}<TQ, TKV, HD, ROWS, BULK>;" in src
        for q, kv in (("__nv_bfloat16", "int8_t"), ("__nv_bfloat16", "__nv_bfloat16"),
                      ("float", "int8_t"), ("float", "float")):
            assert f"{dispatch}<{q}, {kv}>(a)" in src
    entry = (_CSRC / "paged_decode.cu").read_text()
    entry = entry[entry.index('extern "C" int kvt_paged_decode('):]
    entry = entry[entry.index("  if ("):]  # the body's first statement: the refusal
    refusal = entry[:entry.index("return static_cast<int>(cudaErrorInvalidValue);")]
    assert "cluster > 8" in refusal and "dtype" not in refusal


def test_every_f32_flash_runs_the_register_tiled_bodies():
    """The first port's f32 flash body is gone: scores, probabilities and
    the output in shared memory (`FlashSmem`), its `scores_tile` and
    `pv_tile` products and its kernel `flash_prefill_kernel`. Both f32
    launches of kvt_flash_prefill (the padded widths up to 256, and above)
    go through `f32::launch`, which launches the register-tiled body up to
    head_dim 256 and the panel body above it."""
    src = (_CSRC / "flash_prefill.cu").read_text()
    assert not re.search(r"\b(FlashSmem|scores_tile|pv_tile|flash_prefill_kernel)\b", src)
    f32 = src[src.index("namespace f32 {"):src.index("}  // namespace f32")]
    kernels = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\) (\w+)\(", f32))
    assert kernels == {"flash_prefill_f32_kernel", "flash_prefill_f32_panel_kernel"}
    launch = f32[f32.index("cudaError_t launch(const void* q"):]
    assert "if (hd > kPanel) {" in launch
    assert "launch_kernel(flash_prefill_f32_panel_kernel," in launch
    assert "launch_kernel(flash_prefill_f32_kernel<HD>," in launch
    entry = src[src.index('extern "C" int kvt_flash_prefill('):]
    assert re.findall(r"f32::launch<(\w+)>", entry) == ["HD", "256"]


_STAGE_FORMATS = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def _c_stage_table() -> dict:
    """csrc/paged_decode_sm90.cuh's kStageTokens as {page dtype: {padded
    head_dim: tokens}}, its rows named by their comments."""
    src = (_CSRC / "paged_decode_sm90.cuh").read_text()
    body = re.search(r"constexpr int kStageTokens\[3\]\[3\] = \{(.*?)\n\};", src, re.S)
    rows = re.findall(r"\{(\d+), (\d+), (\d+)\},\s*// (\w+)", body.group(1))
    assert [r[3] for r in rows] == list(_STAGE_FORMATS)
    # format_of maps the page types onto those rows in that order.
    assert ("std::is_same<TKV, int8_t>::value ? 0 : std::is_same<TKV, __nv_bfloat16>::value "
            "? 1 : 2") in src
    return {_STAGE_FORMATS[r[3]]: dict(zip((64, 128, 256), map(int, r[:3]))) for r in rows}


@pytest.mark.parametrize("fmt", sorted(_STAGE_FORMATS))
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_stage_tokens_mirror_the_c_table(fmt, hd):
    """decode_plan's cap reads STAGE_TOKENS, the Python copy of the Hopper
    body's stage table (tier-1 cannot build the library): equal entry for
    entry, and every head_dim takes its padded width's entry."""
    page_dtype = _STAGE_FORMATS[fmt]
    assert port_paged.STAGE_TOKENS[page_dtype][hd] == _c_stage_table()[page_dtype][hd]
    lo = {64: 1, 128: 65, 256: 129}[hd]
    assert {port_paged.stage_tokens(d, page_dtype) for d in range(lo, hd + 1)} == {
        port_paged.STAGE_TOKENS[page_dtype][hd]}


def test_paged_attention_bad_grouping_raises():
    q, k, v, bt = (torch.from_numpy(a) for a in _paged_inputs(n_q=6, n_kv=4))
    lens = torch.tensor([8, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible"):
        port_paged.paged_attention(q, k, v, bt, lens)
    with pytest.raises(ValueError, match="not divisible"):
        port_paged.paged_attention_reference(q, k, v, bt, lens)


def test_paged_attention_cpu_tensors_launch_no_kernel():
    before = port_paged.launches
    q, k, v, bt = (torch.from_numpy(a) for a in _paged_inputs())
    lens = torch.tensor([5, 200], dtype=torch.int32)
    for pipelined in (True, False):
        out = port_paged.paged_attention(q, k, v, bt, lens, pipelined=pipelined)
        ref = port_paged.paged_attention_reference(q, k, v, bt, lens)
        assert torch.equal(out, ref)
    assert port_paged.launches == before


@pytest.mark.parametrize("start_pos", [0, 14, 30])
def test_write_kv_pages_matches_jax(start_pos):
    rng = np.random.default_rng(1)
    n_kv, n_pages, ps, hd, seq = 2, 8, 16, 8, 5
    kp = rng.standard_normal((n_kv, n_pages, ps, hd), dtype=np.float32)
    vp = rng.standard_normal((n_kv, n_pages, ps, hd), dtype=np.float32)
    bt = np.array([5, 2, 7], np.int32)
    k_new = rng.standard_normal((seq, n_kv, hd), dtype=np.float32)
    v_new = rng.standard_normal((seq, n_kv, hd), dtype=np.float32)
    want_k, want_v = jax_write_kv_pages(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(k_new), jnp.asarray(v_new), start_pos,
    )
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got_k, got_v = port_paged.write_kv_pages(
        tk, tv, torch.from_numpy(bt), torch.from_numpy(k_new),
        torch.from_numpy(v_new), start_pos,
    )
    assert got_k is tk and got_v is tv  # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))


# The cases of tests/test_flash_prefill.py:
# (b, l, s, n_q, n_kv, hd, offset, window, block_q, block_k).
FLASH_CASES = {
    "causal_from_scratch": (1, 96, 96, 4, 2, 64, 0, None, 32, 128),
    "cached_prefix_offset": (1, 64, 96, 4, 2, 64, 32, None, 32, 128),
    "per_batch_offsets": (2, 48, 80, 4, 2, 64, [5, 17], None, 32, 128),
    "sliding_window": (1, 96, 96, 4, 2, 64, 0, 40, 32, 128),
    "sliding_window_with_offset": (1, 64, 128, 4, 2, 64, 64, 48, 32, 128),
    "mqa": (1, 64, 64, 4, 1, 64, 0, None, 32, 128),
    "wide_gqa": (1, 64, 64, 8, 2, 64, 0, None, 32, 128),
    "non_block_multiple_shapes": (1, 90, 150, 4, 2, 64, 60, None, 32, 128),
    "single_block": (1, 16, 16, 2, 2, 64, 0, None, 16, 128),
}


# The same comparison at head_dim 128, the flagship family's width, so the
# plain version that chip_smoke.py holds the CUDA kernels against is itself
# held against the TPU kernel there: every GQA group the flagship family uses,
# ragged L, per-batch offsets, windows with offsets, rows past the last key
# (the TPU kernel's s_real cut), and a reduced serving chunk (offset > 0, S
# padded past offset + L as the pod pads its table).
FLASH_CASES_HD128 = {
    "group_1": (1, 96, 96, 4, 4, 128, 0, None, 32, 128),
    "group_2_ragged_l": (1, 100, 100, 4, 2, 128, 0, None, 32, 128),
    "group_4_offset": (1, 70, 130, 8, 2, 128, 60, None, 32, 128),
    "group_8": (1, 40, 40, 8, 1, 128, 0, None, 16, 128),
    "per_batch_offsets": (3, 50, 150, 4, 2, 128, [0, 37, 100], None, 32, 128),
    "window_with_offset": (1, 80, 200, 4, 2, 128, 120, 48, 32, 128),
    "per_batch_offsets_window": (2, 64, 192, 4, 2, 128, [10, 90], 40, 32, 128),
    "rows_past_last_key": (1, 24, 40, 4, 2, 128, 30, None, 8, 128),
    "serving_chunk_padded_table": (1, 64, 256, 4, 2, 128, 128, None, 32, 128),
    "single_row_window": (1, 1, 64, 4, 2, 128, 63, 16, 8, 128),
}


# Head_dim 64 (the f32 kernel takes it too now) and GQA group 7, which folds
# 9 positions into a 64-row tile of the CUDA kernel: both Qwen2.5 attention
# shapes (28/4 of 128, 14/2 of 64) with offsets, per-batch offsets and
# windows.
FLASH_CASES_GROUPS = {
    "hd64_group_2_offset": (1, 70, 130, 4, 2, 64, 60, None, 32, 128),
    "hd64_group_7": (1, 50, 50, 14, 2, 64, 0, None, 16, 128),
    "hd64_group_7_per_batch_window": (2, 40, 120, 14, 2, 64, [10, 80], 30, 16, 128),
    "group_7_qwen7b_heads_offset": (1, 30, 96, 28, 4, 128, 66, None, 16, 128),
    "group_7_window": (1, 45, 45, 7, 1, 128, 0, 20, 16, 128),
    "group_12_per_batch": (2, 20, 60, 12, 1, 64, [0, 40], None, 8, 128),
    "group_13_hd64_per_batch": (2, 24, 70, 26, 2, 64, [5, 46], None, 8, 128),
    "group_64_window": (1, 12, 40, 64, 1, 128, 28, 16, 8, 128),
    # Head dims off the built widths (50, 80, 96, 100, 256) and groups above
    # 64 (71 over one kv head splits over two 64-row CTAs, 128 over two).
    "hd50_group_2": (1, 40, 70, 4, 2, 50, 30, None, 8, 128),
    "hd80_per_batch": (2, 24, 60, 8, 4, 80, [0, 36], None, 8, 128),
    "hd96_window": (1, 40, 90, 8, 2, 96, 50, 20, 8, 128),
    "hd100_openllama3b_heads": (1, 20, 52, 32, 32, 100, 32, None, 8, 128),
    "hd100_group_4_window": (1, 30, 64, 16, 4, 100, 34, 24, 8, 128),
    "hd256_gemma7b_heads": (1, 20, 40, 16, 16, 256, 20, None, 8, 128),
    "hd256_group_8_window": (1, 16, 48, 8, 1, 256, 32, 20, 8, 128),
    "group_71_falcon7b_heads": (1, 12, 30, 71, 1, 64, 18, None, 4, 128),
    "group_128_window": (1, 8, 24, 128, 1, 128, 16, 10, 4, 128),
    # Head dims above 256 (column slabs of 256 in the CUDA kernels): groups
    # 1, 2 and 8, per-batch offsets, a window.
    "hd288_group_1": (1, 20, 40, 2, 2, 288, 20, None, 8, 128),
    "hd300_group_2_window": (1, 24, 60, 4, 2, 300, 30, 20, 8, 128),
    "hd512_group_2_per_batch": (2, 16, 48, 4, 2, 512, [0, 32], None, 8, 128),
    "hd576_group_8_window": (1, 16, 40, 16, 2, 576, 24, 12, 8, 128),
}


def _check_flash_case(b, l, s, n_q, n_kv, hd, offset, window, block_q, block_k):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, l, n_q, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, n_kv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, n_kv, hd), dtype=np.float32)
    off_np = np.asarray(offset, np.int32)
    want = jax_flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off_np),
        window=window, block_q=block_q, block_k=block_k, interpret=True,
    )
    off_t = offset if isinstance(offset, int) else torch.from_numpy(off_np)
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    before = port_flash.launches
    got = port_flash.flash_prefill(tq, tk, tv, off_t, window=window)
    plain = port_flash.dense_attention(tq, tk, tv, off_t, window=window)
    assert torch.equal(got, plain) and port_flash.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_dense_attention_matches_flash_kernel(case):
    _check_flash_case(*FLASH_CASES[case])


@pytest.mark.parametrize("case", sorted(FLASH_CASES_HD128))
def test_dense_attention_matches_flash_kernel_hd128(case):
    _check_flash_case(*FLASH_CASES_HD128[case])


@pytest.mark.parametrize("case", sorted(FLASH_CASES_GROUPS))
def test_dense_attention_matches_flash_kernel_groups(case):
    _check_flash_case(*FLASH_CASES_GROUPS[case])


def test_flash_prefill_bad_grouping_raises():
    q = torch.zeros(1, 32, 3, 64)
    k = torch.zeros(1, 32, 2, 64)
    with pytest.raises(ValueError, match="not divisible"):
        port_flash.flash_prefill(q, k, k, 0)


def test_fault_check_mutants_name_one_source_line_each():
    """Each kernel fault of chip_fault_check.py names a line (or lines) that
    stands exactly once in its source, as the planting requires."""
    import chip_fault_check

    for name, (sources, target, old, new, targets, dtype) in chip_fault_check.MUTANTS.items():
        text = (_CSRC / target).read_text()
        assert text.count(old) == 1, name
        assert new != old and dtype in ("bf16", "f32"), name
        assert all((_CSRC / f"{source}.cu").exists() for source in sources), name


def test_fault_check_drops_a_layer_the_flagship_has():
    """The planted train-step fault zeroes one layer's gradients: that layer
    must exist at the depth chip_smoke.py serves the flagship at (a layer
    past it raised IndexError in the fault check's training bar)."""
    import chip_fault_check
    import chip_smoke

    assert 0 <= chip_fault_check.DROPPED_LAYER < chip_smoke.FLAGSHIP["n_layers"]


# (batch, L) of the wide flash plans: the serving chunk (L = 512), a 2,048-
# token chunk, the speculative verify (8 x 5) and a small ragged batch.
FLASH_PLAN_CALLS = {"serving": (1, 512), "chunk2048": (1, 2048), "verify": (8, 5),
                    "b2_l200": (2, 200)}


@pytest.mark.parametrize("call", sorted(FLASH_PLAN_CALLS))
@pytest.mark.parametrize("shape", sorted(WIDE_PLAN_SHAPES))
def test_flash_wide_plan_fits_the_card(shape, call):
    """Above head_dim 256 the bf16 flash kernel runs a cluster of
    n_panels x key_splits CTAs per 64-row query tile: the cluster stays
    within the portable 8, and the key splits are the most that keep one CTA
    per SM (at least 1)."""
    n_q, n_kv, hd = WIDE_PLAN_SHAPES[shape]
    batch, l = FLASH_PLAN_CALLS[call]
    n_pan, splits = port_flash.wide_plan(batch, l, n_q, n_kv, hd, 132)
    assert n_pan == -(-hd // 256) and splits >= 1 and n_pan * splits <= 8
    group = n_q // n_kv
    gc = port_flash.head_chunk(group, 64)
    tiles = batch * n_kv * -(-group // gc) * -(-l // (64 // gc))
    if tiles * n_pan <= 132:
        assert tiles * n_pan * splits <= 132
    else:
        assert splits == 1
    assert n_pan * (splits + 1) > 8 or tiles * n_pan * (splits + 1) > 132


def test_flash_wide_plan_serving_chunk_and_limit():
    """Phase 21's serving chunk (4/2 heads of 512) takes 2 key splits on 132
    SMs: 32 tiles x 2 panels x 2 = 128 CTAs. Up to head_dim 2,048 the panels
    fit the portable cluster of 8; above it (more than 8 panels) the kernel
    walks them, one CTA a slab, and takes no key split. Groups split as the
    kernel's head_chunk."""
    assert port_flash.wide_plan(1, 512, 4, 2, 512, 132) == (2, 2)
    assert port_flash.wide_plan(1, 512, 4, 2, 2048, 132) == (8, 1)
    assert port_flash.wide_plan(1, 512, 4, 2, 2049, 132) == (9, 1)
    assert port_flash.wide_plan(1, 5, 4, 2, 4096, 132) == (16, 1)
    assert [port_flash.head_chunk(g, 64) for g in (1, 16, 64, 65, 71, 128)] == [
        1, 16, 64, 33, 36, 64]



@pytest.mark.parametrize("call", sorted(FLASH_PLAN_CALLS))
@pytest.mark.parametrize("hd", [2049, 2304, 3000, 4096, 8192])
def test_flash_wide_plan_walks_panels_above_2048(hd, call):
    """Every head_dim above 2,048 has a bf16 launch: the panels of 256,
    one CTA a slab, no key split (the C entry point refuses any other)."""
    batch, l = FLASH_PLAN_CALLS[call]
    assert port_flash.wide_plan(batch, l, 4, 2, hd, 132) == (-(-hd // 256), 1)

