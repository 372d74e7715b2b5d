"""The port's attention ops against the JAX package's kernels.

Inputs come from seeded numpy and go through both packages; the JAX Pallas
kernels run in interpret mode on the CPU, as the JAX package's own tests run
them. On CPU tensors the port's wrappers run their plain torch versions
(the CUDA kernels are held against those same versions on the card by
chip_smoke.py). f32 throughout; tolerance atol = rtol = 1e-5. Also on the
CPU: the decode kernels' launch plan (by q's dtype), and the ctypes argument
lists against the C entry points they call.
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
    """f32 q (on f32 or int8 pages) keeps the first port's split rule
    (about two CTAs per SM)."""
    assert port_paged.old_body_splits(batch, 8, width, 132) == want


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_launch_plan_follows_q_dtype(case, q_dtype):
    """bf16 q runs the Hopper body on bf16 and on int8 pages alike and takes
    decode_plan; f32 q keeps the old body: old_body_splits, no cluster. The
    page format does not enter the plan: both formats stage 64 tokens."""
    batch, n_kv, width, page, n_sms = PLAN_CASES[case]
    got = port_paged._plan(n_sms, q_dtype, batch, n_kv, width, page)
    if q_dtype == torch.bfloat16:
        assert got == port_paged.decode_plan(batch, n_kv, width, page, n_sms)
    else:
        assert got == (1, port_paged.old_body_splits(batch, n_kv, width, n_sms))


_CTYPE = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
_CSRC = Path(port_paged.__file__).resolve().parent.parent / "csrc"


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
                                     "kvt_paged_decode_tiled"])
def test_ctypes_argtypes_match_c_signatures(fn_name):
    """A ctypes argument list that disagrees with the C entry point cuts
    pointers or shifts arguments silently on the card."""
    sigs = _c_signatures()
    assert sorted(sigs) == sorted({**port_paged._ARGTYPES, **port_flash._ARGTYPES})
    assert sigs[fn_name] == {**port_paged._ARGTYPES, **port_flash._ARGTYPES}[fn_name]


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


# The same comparison at head_dim 128, the only width the port's CUDA kernels
# take, so the plain version that chip_smoke.py holds them against is itself
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


def test_flash_prefill_bad_grouping_raises():
    q = torch.zeros(1, 32, 3, 64)
    k = torch.zeros(1, 32, 2, 64)
    with pytest.raises(ValueError, match="not divisible"):
        port_flash.flash_prefill(q, k, k, 0)
