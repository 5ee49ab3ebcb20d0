"""Parity of the port's block-sparse attention
(deepspeed_tpu_torch/ops/sparse_attention, its plain versions on the CPU)
with the JAX package's, whose Pallas kernels run in interpret mode as the
JAX package's own tests (tests/unit/ops/test_sparse_attention.py) run them,
at that file's sizes: H 2, block 8, T 64.

Inputs come from numpy with a seed and go to both packages. Cases:

* layouts of all seven config classes bit-identical (BigBird's and
  Variable's seeds, ``different_layout_per_head``,
  ``num_different_global_patterns``), the same validation errors, and equal
  look-up tables;
* forward out and lse against JAX ``_sparse_attention_fwd`` within the
  reference test's own f32 bounds (rtol 2e-4, atol 2e-5) over its seven
  config/causal cases; both sides compute in f32 and differ only in
  summation order;
* dQ, dK and dV through the port's autograd against ``jax.grad`` of
  ``block_sparse_attention`` within the reference test's 5e-4 / 5e-5;
* a row with no visible key (``causal=True`` over a bidirectional layout):
  zeros on both sides, forward and gradients;
* bf16 operands: the port's output within 8e-3 relative + 1e-2 absolute of
  JAX's. Both read bf16, compute in f32 and round the output once, so they
  differ by at most one bf16 ulp (2^-8 relative) of O(1) values;
* the kernels' work lists (``work_list``): over the transposed table
  (dK/dV) and over the table itself (dQ, and the forward, whose list is
  dQ's) each covers every (head, block, block) entry exactly once, in
  table order within a line, with a cut line's parts on consecutive
  partial slots in part order and an empty line as one empty part, over
  the fourteen layout cases (with a cap that cuts their lines) and the chip
  run's two full-size layouts; the plain dK/dV, and the plain dQ, summed
  part by part in part order equal the plain versions within 1e-6 relative
  in f32, and that dQ equals JAX's (``_bwd_dq_kernel`` in interpret mode)
  within the gradient bounds above; the plain forward computed part by
  part and merged in part order (each part's acc, m and l) equals the plain
  version within 1e-6 relative (lse within 1e-6 absolute) and JAX's
  ``_fwd_kernel`` in interpret mode within the forward bounds above, at
  Fixed, BigBird (also under causal, so whole parts see no key) and
  Longformer layouts with cuts forced and at a row with no visible key; the
  group-busy share the dK/dV list gives at the chip run's layout (a) is at
  least 0.9, where four consecutive key blocks to a CUDA block (the first
  form of the kernel) give 0.259, and the dQ (forward) list's at layout
  (b) at least 0.95 (0.9), where four consecutive query blocks give 0.668;
* ``SparseSelfAttention``: the causal default from the config, the layout
  cache per sequence length, ``pad_to_block_size`` and
  ``unpad_sequence_output``;
* the op registry: the same names as the JAX package's, ``sparse_attn``
  loads the port's module, an op that is not ported raises
  ``NotPortedError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.sparse_attention as jsa
from deepspeed_tpu.ops import all_ops as jax_all_ops
from deepspeed_tpu.ops.sparse_attention import block_sparse as jbs
from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.errors import NotPortedError
from deepspeed_tpu_torch.ops import all_ops, get_op_builder
from deepspeed_tpu_torch.ops.kernel_check import (dkv_by_parts, dq_by_parts,
                                                  flash_inputs, fwd_by_parts,
                                                  masked_row_layout, rel_err)
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as tbs
import deepspeed_tpu_torch.ops.sparse_attention as tsa

H, BLK, T = 2, 8, 64  # 8 blocks

# (class name, constructor kwargs): every class, BigBird's and Variable's
# seeds, per-head layouts and different global patterns
LAYOUT_CASES = [
    ("DenseSparsityConfig", {}),
    ("FixedSparsityConfig", dict(num_local_blocks=2, num_global_blocks=1)),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1,
                                 attention="unidirectional")),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1,
                                 horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=2,
                                 different_layout_per_head=True,
                                 num_different_global_patterns=2)),
    ("VariableSparsityConfig", dict(num_random_blocks=2,
                                    local_window_blocks=[1, 2, 3],
                                    global_block_indices=[0, 5],
                                    global_block_end_indices=[2, 7],
                                    horizontal_global_attention=True,
                                    different_layout_per_head=True, seed=4)),
    ("VariableSparsityConfig", dict(local_window_blocks=[2],
                                    attention="unidirectional")),
    ("BigBirdSparsityConfig", dict(seed=0)),
    ("BigBirdSparsityConfig", dict(num_random_blocks=2, seed=7,
                                   different_layout_per_head=True)),
    ("BigBirdSparsityConfig", dict(attention="unidirectional", seed=3)),
    ("BSLongformerSparsityConfig", dict(global_block_indices=[1, 5],
                                        global_block_end_indices=[3, 6])),
    ("BSLongformerSparsityConfig", dict(num_sliding_window_blocks=5,
                                        attention="unidirectional")),
    ("LocalSlidingWindowSparsityConfig", {}),
    ("LocalSlidingWindowSparsityConfig", dict(num_sliding_window_blocks=4,
                                              attention="bidirectional")),
]


@pytest.mark.parametrize("cls,kw", LAYOUT_CASES,
                         ids=[f"{c}-{i}" for i, (c, _) in enumerate(LAYOUT_CASES)])
def test_layouts_bit_identical_and_luts_equal(cls, kw):
    heads = 4 if kw.get("different_layout_per_head") else H
    ref = getattr(jsa, cls)(num_heads=heads, block=BLK, **kw).make_layout(T)
    got = getattr(tsa, cls)(num_heads=heads, block=BLK, **kw).make_layout(T)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(tbs._build_luts(got), jbs._build_luts(ref)):
        np.testing.assert_array_equal(a, b)
    luts = tbs.sparse_luts(got, "cpu")
    np.testing.assert_array_equal(luts.lut_q.numpy(), jbs._build_luts(ref)[0])
    np.testing.assert_array_equal(luts.cnt_q.numpy(), ref.sum(2))
    np.testing.assert_array_equal(luts.cnt_k.numpy(), ref.sum(1))


@pytest.mark.parametrize("cls,kw", [
    ("FixedSparsityConfig", dict(num_local_blocks=3, num_global_blocks=2)),
    ("FixedSparsityConfig", dict(attention="sideways")),
    ("FixedSparsityConfig", dict(attention="unidirectional",
                                 horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(num_different_global_patterns=2)),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=2,
                                 different_layout_per_head=True,
                                 num_different_global_patterns=3)),
    ("VariableSparsityConfig", dict(global_block_indices=[0, 2],
                                    global_block_end_indices=[1])),
])
def test_validation_errors_match(cls, kw):
    with pytest.raises(ValueError) as ref:
        getattr(jsa, cls)(num_heads=H, block=BLK, **kw)
    with pytest.raises(ValueError) as got:
        getattr(tsa, cls)(num_heads=H, block=BLK, **kw)
    assert str(got.value) == str(ref.value)


def test_bad_seq_len_raises_the_same_error():
    with pytest.raises(ValueError) as ref:
        jsa.FixedSparsityConfig(num_heads=H, block=BLK).make_layout(T + 3)
    with pytest.raises(ValueError) as got:
        tsa.FixedSparsityConfig(num_heads=H, block=BLK).make_layout(T + 3)
    assert str(got.value) == str(ref.value)


def test_first_head_layout_propagates():
    cfg = tsa.BigBirdSparsityConfig(num_heads=4, block=BLK, seed=3)
    lo = cfg.make_layout(T)
    assert (lo[0] == lo[1]).all() and (lo[0] == lo[3]).all()
    per_head = tsa.BigBirdSparsityConfig(num_heads=4, block=BLK, seed=3,
                                         different_layout_per_head=True)
    assert not (per_head.make_layout(T)[0] == per_head.make_layout(T)[1]).all()


# the reference test's seven config/causal cases
CONFIGS = [
    ("dense", "DenseSparsityConfig", {}, False),
    ("fixed", "FixedSparsityConfig", dict(num_local_blocks=2,
                                          num_global_blocks=1), False),
    ("fixed_causal", "FixedSparsityConfig",
     dict(num_local_blocks=2, attention="unidirectional"), True),
    ("bigbird", "BigBirdSparsityConfig", dict(num_random_blocks=1,
                                              num_sliding_window_blocks=3), False),
    ("longformer", "BSLongformerSparsityConfig",
     dict(num_sliding_window_blocks=3), False),
    ("sliding", "LocalSlidingWindowSparsityConfig",
     dict(num_sliding_window_blocks=3), True),
    ("variable", "VariableSparsityConfig",
     dict(local_window_blocks=[1, 2], global_block_indices=[0]), False),
]


def _layout(cls, kw, heads=H):
    return getattr(jsa, cls)(num_heads=heads, block=BLK, **kw).make_layout(T)


def _qkv(b=2, t=T, h=H, dh=16, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, t, h, dh) * 0.3).astype(np.float32) for _ in range(3)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name,cls,kw,causal", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_forward_and_lse_match_jax_kernel(name, cls, kw, causal):
    q, k, v = _qkv()
    layout = _layout(cls, kw)
    jout, (_, _, _, _, jlse, _) = jbs._sparse_attention_fwd(
        *map(jnp.asarray, (q, k, v)), layout, BLK, causal, None, True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = tbs.block_sparse_attention(tq, tk, tv, layout, BLK, causal)
    np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-4, atol=2e-5)
    flat = [tbs._reshape_bh(x) for x in (tq, tk, tv)]
    _, lse = tbs.block_sparse_fwd(*flat, tbs.sparse_luts(layout, "cpu"),
                                  block=BLK, causal=causal)
    np.testing.assert_allclose(_np(lse), _np(jlse)[..., 0], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name,cls,kw,causal", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_gradients_match_jax_kernel(name, cls, kw, causal):
    q, k, v = _qkv(b=1, dh=8, seed=1)
    layout = _layout(cls, kw)

    def jloss(q, k, v):
        return jnp.sum(jbs.block_sparse_attention(q, k, v, layout, BLK,
                                                  causal) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tbs.block_sparse_attention(tq, tk, tv, layout, BLK, causal).square().sum().backward()
    for n, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(_np(a), _np(b), rtol=5e-4, atol=5e-5,
                                   err_msg=f"d{n}")


def test_oracle_matches_jax_oracle():
    q, k, v = _qkv(seed=2)
    layout = _layout("BigBirdSparsityConfig", {})
    for causal in (False, True):
        ref = jbs.block_sparse_attention_reference(
            *map(jnp.asarray, (q, k, v)), layout, BLK, causal)
        got = tbs.block_sparse_attention_reference(
            *map(torch.from_numpy, (q, k, v)), layout, BLK, causal)
        np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-5, atol=2e-6)


def test_row_with_no_visible_key_is_zero_on_both_sides():
    """Query block 1 sees only key block 2: causal masks all of it (its keys
    lie after its rows), so block 1 sees nothing."""
    layout = masked_row_layout(H, T // BLK)
    q, k, v = _qkv(b=1, dh=8, seed=3)
    jout, (_, _, _, _, jlse, _) = jbs._sparse_attention_fwd(
        *map(jnp.asarray, (q, k, v)), layout, BLK, True, None, True)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tbs.block_sparse_attention(tq, tk, tv, layout, BLK, True)
    rows = slice(BLK, 2 * BLK)
    assert (_np(out)[:, rows] == 0).all() and (_np(jout)[:, rows] == 0).all()
    np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-4, atol=2e-5)
    flat = [tbs._reshape_bh(x.detach()) for x in (tq, tk, tv)]
    _, lse = tbs.block_sparse_fwd(*flat, tbs.sparse_luts(layout, "cpu"),
                                  block=BLK, causal=True)
    assert (_np(lse)[:, rows] == _np(jlse)[:, rows, 0]).all()
    assert (_np(lse)[:, rows] <= -1e30).all()
    out.square().sum().backward()
    jg = jax.grad(lambda q, k, v: jnp.sum(jbs.block_sparse_attention(
        q, k, v, layout, BLK, True) ** 2), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    assert (_np(tq.grad)[:, rows] == 0).all() and (_np(jg[0])[:, rows] == 0).all()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(_np(a), _np(b), rtol=5e-4, atol=5e-5)


def test_bf16_forward_within_one_ulp_of_jax():
    q, k, v = _qkv(seed=4)
    layout = _layout("FixedSparsityConfig", dict(num_local_blocks=2,
                                                  attention="unidirectional"))
    jout = jbs.block_sparse_attention(*(jnp.asarray(x, jnp.bfloat16)
                                        for x in (q, k, v)), layout, BLK, True)
    out = tbs.block_sparse_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                                       for x in (q, k, v)), layout, BLK, True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jout), rtol=8e-3, atol=1e-2)


def test_plain_versions_walk_only_table_columns():
    """The plain backward kernels agree with autograd of the dense oracle
    at block 16 and Dh 64 (a shape the CUDA kernels take), causal."""
    t, h, blk = 96, 2, 16
    cfg = tsa.FixedSparsityConfig(num_heads=h, block=blk, num_local_blocks=2,
                                  attention="unidirectional")
    layout = cfg.make_layout(t)
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(2, t, h, 64).astype(np.float32)
                                    ).requires_grad_() for _ in range(4))
    out = tbs.block_sparse_attention(q, k, v, layout, blk, True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    ref = tbs.block_sparse_attention_reference(q, k, v, layout, blk, True)
    rgrads = torch.autograd.grad(ref, (q, k, v), do)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    for a, b in zip(grads, rgrads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# chip_smoke.py's full-size layouts: (a) GPT-style causal at T 8192 and
# (b) BigBird at T 4096, block 16
def _layout_a():
    return tsa.FixedSparsityConfig(num_heads=32, block=16, num_local_blocks=4,
                                   num_global_blocks=1,
                                   attention="unidirectional").make_layout(8192)


def _layout_b():
    return tsa.BigBirdSparsityConfig(num_heads=16, block=16).make_layout(4096)


def _case_layout(i):
    cls, kw = LAYOUT_CASES[i]
    heads = 4 if kw.get("different_layout_per_head") else H
    return getattr(tsa, cls)(num_heads=heads, block=BLK, **kw).make_layout(T)


WORK_CASES = ([(f"case{i}", i, part) for i in range(len(LAYOUT_CASES))
               for part in (3, 64)]
              + [("a_fixed_t8192", "a", 64), ("b_bigbird_t4096", "b", 64)])


def _work_layout(which):
    layout = {"a": _layout_a, "b": _layout_b}.get(which, lambda: _case_layout(which))()
    return np.asarray(layout) != 0


def _check_work_list(lines, part):
    """``work_list`` over the lines of ``lines [H, nb, nb]`` (a table's rows
    as booleans): every active (head, line, entry) exactly once, in table
    order, parts tiling each line, an empty line one empty part, cut lines
    on consecutive slots in part order."""
    lut, cnt = tbs._active_lut(lines)
    items, merge, n_slots = tbs.work_list(cnt, part)
    h, nb = cnt.shape
    counts = items[:, 2]
    assert (np.diff(counts) <= 0).all()                 # longest first
    assert (counts <= part).all() and (counts >= 0).all()
    seen = np.zeros((h, nb, nb), dtype=np.int64)
    by_line = {}
    for line, first, count, slot in items:
        hh, i = divmod(int(line), nb)
        for j in lut[hh, i, first:first + count]:
            seen[hh, i, j] += 1
        by_line.setdefault(int(line), []).append((first, count, slot))
    # every active (head, line, entry) exactly once
    np.testing.assert_array_equal(seen, lines.astype(np.int64))
    assert sorted(by_line) == list(range(h * nb))
    merges = {int(m[0]): m for m in merge}
    for line, parts in by_line.items():
        parts.sort()
        starts = [f for f, _, _ in parts]
        # parts tile the line in table order
        assert starts == [i * part for i in range(len(parts))]
        assert sum(c for _, c, _ in parts) == cnt.reshape(-1)[line]
        if cnt.reshape(-1)[line] == 0:                  # one empty part
            assert [c for _, c, _ in parts] == [0]
        slots = [sl for _, _, sl in parts]
        if len(parts) == 1:
            assert slots == [-1] and line not in merges
        else:                              # consecutive slots in part order
            first_slot, n_parts = merges[line][1], merges[line][2]
            assert n_parts == len(parts)
            assert slots == list(range(first_slot, first_slot + n_parts))
    assert n_slots == sum(len(p) for p in by_line.values() if len(p) > 1)


@pytest.mark.parametrize("name,which,part", WORK_CASES,
                         ids=[c[0] + f"-p{c[2]}" for c in WORK_CASES])
def test_dkv_work_list_covers_the_transposed_table(name, which, part):
    _check_work_list(_work_layout(which).transpose(0, 2, 1), part)


@pytest.mark.parametrize("name,which,part", WORK_CASES,
                         ids=[c[0] + f"-p{c[2]}" for c in WORK_CASES])
def test_dq_work_list_covers_the_table(name, which, part):
    _check_work_list(_work_layout(which), part)


@pytest.mark.parametrize("name,which,part", WORK_CASES,
                         ids=[c[0] + f"-p{c[2]}" for c in WORK_CASES])
def test_fwd_work_list_covers_the_table(name, which, part):
    """The forward walks the table's rows with dQ's row groups, so its work
    list is dQ's: it covers the table (as the dQ test checks), and
    ``sparse_luts`` hands out the dQ list under the forward's names."""
    layout = _work_layout(which)
    _check_work_list(layout, part)
    if part == tbs._PART:
        luts = tbs.sparse_luts(layout, "cpu")
        items, merge, slots = tbs.work_list(luts.cnt_q.numpy(), part)
        assert luts.fwd_items is luts.dq_items and luts.fwd_merge is luts.dq_merge
        np.testing.assert_array_equal(luts.fwd_items.numpy(), items)
        np.testing.assert_array_equal(luts.fwd_merge.numpy(), merge)
        assert luts.fwd_slots == luts.dq_slots == slots


def test_luts_carry_both_work_lists():
    """``sparse_luts`` caches the dQ list over the row counts and the dK/dV
    list over the column counts, as ``work_list`` builds them."""
    layout = _layout("BigBirdSparsityConfig", dict(seed=0))
    luts = tbs.sparse_luts(layout, "cpu")
    for items, merge, slots, cnt in (
            (luts.dq_items, luts.dq_merge, luts.dq_slots, luts.cnt_q),
            (luts.dkv_items, luts.dkv_merge, luts.dkv_slots, luts.cnt_k)):
        want = tbs.work_list(cnt.numpy())
        np.testing.assert_array_equal(items.numpy(), want[0])
        np.testing.assert_array_equal(merge.numpy(), want[1])
        assert slots == want[2]


@pytest.mark.parametrize("which,part,causal", [
    ("fixed_unidirectional", 3, True), ("bigbird", 2, False),
    ("longformer", 4, False)])
def test_dkv_parts_sum_to_the_plain_version(which, part, causal):
    """The plain dK/dV summed part by part, in part order (as the kernel's
    merge sums its partials), equals the plain version within 1e-6
    relative in f32: only the order of the f32 sums differs."""
    t, blk, h = 256, 8, 2
    cfg = {"fixed_unidirectional": tsa.FixedSparsityConfig(
               num_heads=h, block=blk, num_local_blocks=2,
               attention="unidirectional"),
           "bigbird": tsa.BigBirdSparsityConfig(num_heads=h, block=blk, seed=1),
           "longformer": tsa.BSLongformerSparsityConfig(
               num_heads=h, block=blk, global_block_indices=[0, 9])}[which]
    layout = cfg.make_layout(t)
    luts = tbs.sparse_luts(layout, "cpu")
    assert tbs.work_list(luts.cnt_k.numpy(), part)[2] > 0   # cuts happen
    rng = np.random.RandomState(11)
    qf, kf, vf, dof = (torch.from_numpy(rng.randn(2 * h, t, 64).astype(np.float32))
                       for _ in range(4))
    out, lse = tbs.block_sparse_fwd_plain(qf, kf, vf, luts, block=blk,
                                          causal=causal)
    delta = tbs.block_sparse_delta(dof, out)
    ref = tbs.block_sparse_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, luts,
                                         block=blk, causal=causal)
    got = dkv_by_parts(qf, kf, vf, dof, lse, delta, luts, block=blk,
                       causal=causal, part=part)
    for a, r in zip(got, ref):
        assert rel_err(a, r) <= 1e-6


def test_dkv_group_busy_at_layout_a():
    """The work list keeps at least 0.9 of the row groups busy at layout (a),
    where four consecutive key blocks to a CUDA block keep 0.259 (column
    counts 4, 3, 2, 509, ...: the global column sets each block's time)."""
    luts = tbs.sparse_luts(_layout_a(), "cpu")
    groups = tbs.row_groups(16)
    assert groups == 4
    cnt = luts.cnt_k.numpy()
    assert list(cnt[0, :4]) == [4, 3, 2, 509]
    assert round(tbs.group_busy(cnt.reshape(-1), groups), 3) == 0.259
    assert tbs.group_busy(luts.dkv_items[:, 2].numpy(), groups) >= 0.9


@pytest.mark.parametrize("which,part,causal", [
    ("fixed_unidirectional", 3, True), ("bigbird", 2, False),
    ("longformer", 4, False)])
def test_dq_parts_sum_to_the_plain_version_and_jax(which, part, causal):
    """The plain dQ summed part by part, in part order (as the dQ kernel's
    merge sums its partials), equals the plain version within 1e-6
    relative in f32 (only the order of the f32 sums differs), and JAX's dQ
    (``_bwd_dq_kernel`` in interpret mode, through ``jax.vjp``) within the
    reference test's 5e-4 / 5e-5."""
    t, blk, h, dh = 128, 8, 2, 16
    cfg = {"fixed_unidirectional": tsa.FixedSparsityConfig(
               num_heads=h, block=blk, num_local_blocks=2,
               attention="unidirectional"),
           "bigbird": tsa.BigBirdSparsityConfig(num_heads=h, block=blk, seed=1),
           "longformer": tsa.BSLongformerSparsityConfig(
               num_heads=h, block=blk, global_block_indices=[0, 9])}[which]
    layout = cfg.make_layout(t)
    luts = tbs.sparse_luts(layout, "cpu")
    assert tbs.work_list(luts.cnt_q.numpy(), part)[2] > 0   # cuts happen
    q, k, v = _qkv(b=2, t=t, h=h, dh=dh, seed=12)
    do = (np.random.RandomState(13).randn(2, t, h, dh) * 0.3).astype(np.float32)
    _, vjp = jax.vjp(lambda q_: jbs.block_sparse_attention(
        q_, jnp.asarray(k), jnp.asarray(v), layout, blk, causal), jnp.asarray(q))
    (jdq,) = vjp(jnp.asarray(do))
    qf, kf, vf, dof = (tbs._reshape_bh(torch.from_numpy(x)) for x in (q, k, v, do))
    out, lse = tbs.block_sparse_fwd_plain(qf, kf, vf, luts, block=blk,
                                          causal=causal)
    delta = tbs.block_sparse_delta(dof, out)
    ref = tbs.block_sparse_bwd_dq_plain(qf, kf, vf, dof, lse, delta, luts,
                                        block=blk, causal=causal)
    got = dq_by_parts(qf, kf, vf, dof, lse, delta, luts, block=blk,
                      causal=causal, part=part)
    assert rel_err(got, ref) <= 1e-6
    np.testing.assert_allclose(_np(tbs._unshape_bh(got, 2, h)), _np(jdq),
                               rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("which,part,causal", [
    ("fixed_unidirectional", 3, True), ("bigbird", 2, False),
    ("bigbird", 2, True), ("longformer", 4, False), ("masked", 1, True)])
def test_fwd_parts_merge_to_the_plain_version_and_jax(which, part, causal):
    """The plain forward computed part by part (each part's acc, m and l)
    and merged in part order, as the forward kernel's merge launch combines
    its partials, equals the plain version within 1e-6 relative in f32 (lse
    within 1e-6 absolute: only the order of the f32 sums differs), and JAX's
    forward (``_fwd_kernel`` in interpret mode) within the reference test's
    2e-4 / 2e-5. BigBird under causal cuts rows whose later parts see no
    key (they must add nothing); the masked layout's query block 1 sees no
    key at all (out 0, lse -1e30 on both sides)."""
    t, blk, h, dh = 128, 8, 2, 16
    nb = t // blk
    layout = {"fixed_unidirectional": lambda: tsa.FixedSparsityConfig(
                  num_heads=h, block=blk, num_local_blocks=2,
                  attention="unidirectional").make_layout(t),
              "bigbird": lambda: tsa.BigBirdSparsityConfig(
                  num_heads=h, block=blk, seed=1).make_layout(t),
              "longformer": lambda: tsa.BSLongformerSparsityConfig(
                  num_heads=h, block=blk, global_block_indices=[0, 9]).make_layout(t),
              "masked": lambda: masked_row_layout(h, nb)}[which]()
    luts = tbs.sparse_luts(layout, "cpu")
    assert tbs.work_list(luts.cnt_q.numpy(), part)[2] > 0   # cuts happen
    q, k, v = _qkv(b=2, t=t, h=h, dh=dh, seed=14)
    jout, (_, _, _, _, jlse, _) = jbs._sparse_attention_fwd(
        *map(jnp.asarray, (q, k, v)), layout, blk, causal, None, True)
    flat = [tbs._reshape_bh(torch.from_numpy(x)) for x in (q, k, v)]
    ref, ref_lse = tbs.block_sparse_fwd_plain(*flat, luts, block=blk,
                                              causal=causal)
    got, lse = fwd_by_parts(*flat, luts, block=blk, causal=causal, part=part)
    assert rel_err(got, ref) <= 1e-6
    assert (lse - ref_lse).abs().max().item() <= 1e-6
    np.testing.assert_allclose(_np(tbs._unshape_bh(got, 2, h)), _np(jout),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(jlse)[..., 0], rtol=2e-4, atol=2e-5)
    if which == "masked":
        rows = slice(blk, 2 * blk)
        assert (got[:, rows] == 0).all() and (lse[:, rows] <= -1e30).all()


def test_fwd_group_busy_at_layout_b():
    """The forward's work list (dQ's) keeps at least 0.9 of the row groups
    busy at layout (b), BigBird at T 4096, where the first form of the
    forward, four consecutive query blocks to a CUDA block, keeps 0.668."""
    luts = tbs.sparse_luts(_layout_b(), "cpu")
    groups = tbs.row_groups(16)
    assert round(tbs.group_busy(luts.cnt_q.numpy().reshape(-1), groups), 3) == 0.668
    assert tbs.group_busy(luts.fwd_items[:, 2].numpy(), groups) >= 0.9


def test_dq_group_busy_at_layout_b():
    """The dQ work list keeps at least 0.95 of the row groups busy at layout
    (b), BigBird at T 4096, where four consecutive query blocks to a CUDA
    block (the first form of the kernel) keep 0.668: the CUDA block of a
    global row (256 entries against a mean of about 6) waits on it."""
    luts = tbs.sparse_luts(_layout_b(), "cpu")
    groups = tbs.row_groups(16)
    cnt = luts.cnt_q.numpy()
    assert cnt.max() == 256 and cnt.mean() < 7
    assert round(tbs.group_busy(cnt.reshape(-1), groups), 3) == 0.668
    assert tbs.group_busy(luts.dq_items[:, 2].numpy(), groups) >= 0.95


# f32 dQ against an f64 run of the same arithmetic: the f32 summation
# orders measured at the long causal case below read 0.36e-5 to 1.19e-5
# (the plain version here, the kernels on the card)
F64_DQ_BOUND = 2e-5


def test_f32_dq_orders_against_f64_at_a_long_causal_layout():
    """At block 64, T 4352 (68 blocks), 2 heads of Dh 128, Fixed causal (4
    local blocks), B 2, ``flash_inputs`` seed 192: the plain f32 dQ and the
    part-wise sums of the dQ kernel's work list (parts of 64 entries, and of
    8, which cuts every row) each stay within ``F64_DQ_BOUND`` of an f64 run
    of the plain arithmetic on the same lse and delta. dS = p (dP - delta)
    cancels on the early causal rows, so each f32 order's own error there
    nears the 1e-5 bound the kernels keep against the plain version."""
    h, block, nb, dh = 2, 64, 68, 128
    cfg = tsa.FixedSparsityConfig(num_heads=h, block=block, num_local_blocks=4,
                                  attention="unidirectional")
    luts = tbs.sparse_luts(cfg.make_layout(nb * block), "cpu")
    q, k, v, do = flash_inputs("cpu", torch.float32, 2 * h, nb * block, dh,
                               seed=192)
    kw = dict(block=block, causal=True)
    out, lse = tbs.block_sparse_fwd_plain(q, k, v, luts, **kw)
    delta = tbs.block_sparse_delta(do, out)
    ref64 = tbs.block_sparse_bwd_dq_plain(
        *(x.double() for x in (q, k, v, do)), lse, delta, luts, **kw)
    assert ref64.dtype == torch.float64
    plain = tbs.block_sparse_bwd_dq_plain(q, k, v, do, lse, delta, luts, **kw)
    assert 0 < rel_err(plain, ref64) <= F64_DQ_BOUND
    for part in (64, 8):
        got = dq_by_parts(q, k, v, do, lse, delta, luts, part=part, **kw)
        assert rel_err(got, ref64) <= F64_DQ_BOUND, (part, rel_err(got, ref64))


class TestSparseSelfAttention:
    def test_causal_default_from_config(self):
        q, k, v = _qkv()
        cfg = dict(num_local_blocks=2, attention="unidirectional")
        mod = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
            num_heads=H, block=BLK, **cfg))
        jmod = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(
            num_heads=H, block=BLK, **cfg))
        assert isinstance(mod, torch.nn.Module) and not list(mod.parameters())
        out = mod(*map(torch.from_numpy, (q, k, v)))
        jout = jmod(*map(jnp.asarray, (q, k, v)))
        np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-4, atol=2e-5)
        causal = tbs.block_sparse_attention_reference(
            *map(torch.from_numpy, (q, k, v)), mod.get_layout(T), BLK, True)
        torch.testing.assert_close(out, causal, rtol=2e-4, atol=2e-5)
        bidir = mod(*map(torch.from_numpy, (q, k, v)), causal=False)
        assert not torch.allclose(bidir, out)

    def test_layout_cached_per_seq_len(self):
        mod = tsa.SparseSelfAttention(tsa.BigBirdSparsityConfig(num_heads=H,
                                                                block=BLK))
        l1 = mod.get_layout(T)
        assert mod.get_layout(T) is l1
        assert mod.get_layout(2 * T).shape == (H, 2 * T // BLK, 2 * T // BLK)
        assert mod.get_layout(T) is l1

    def test_pad_to_block_size(self):
        ids = torch.ones((2, 30), dtype=torch.int32)
        mask = torch.ones((2, 30), dtype=torch.int32)
        pad, padded, pmask = tsa.SparseSelfAttention.pad_to_block_size(
            16, ids, 7, mask)
        assert pad == 2 and padded.shape == (2, 32) and pmask.shape == (2, 32)
        assert (padded[:, 30:] == 7).all() and (pmask[:, 30:] == 0).all()
        assert tsa.SparseSelfAttention.pad_to_block_size(16, padded, 0)[0] == 0
        out = tsa.SparseSelfAttention.unpad_sequence_output(
            pad, torch.ones((2, 32, 4)))
        assert out.shape == (2, 30, 4)


class TestRegistry:
    def test_same_op_names_as_the_jax_package(self):
        assert sorted(all_ops()) == sorted(jax_all_ops())

    def test_sparse_attn_loads_the_port(self):
        builder = get_op_builder("sparse_attn")(get_accelerator("cpu"))
        assert builder.is_compatible() and not builder.has_fast_path()
        assert builder.load() is tsa
        assert builder.load().SparseSelfAttention is tsa.SparseSelfAttention

    @pytest.mark.parametrize("name", ["cpu_adam", "cpu_adagrad",
                                      "ring_attention", "async_io", "onebit",
                                      "cpu_adam_native"])
    def test_unported_op_raises(self, name):
        builder = get_op_builder(name)(get_accelerator("cpu"))
        assert not builder.is_compatible()
        with pytest.raises(NotPortedError):
            builder.load()

    @pytest.mark.parametrize("name", ["fused_adam", "fused_lamb", "attention",
                                      "flash_attention"])
    def test_ported_ops_load(self, name):
        assert get_op_builder(name)(get_accelerator("cpu")).load() is not None

    def test_unknown_op_raises(self):
        with pytest.raises(KeyError):
            get_op_builder("no_such_op")
