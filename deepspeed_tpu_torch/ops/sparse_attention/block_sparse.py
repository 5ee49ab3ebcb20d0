"""Block-sparse attention (port of
deepspeed_tpu/ops/sparse_attention/block_sparse.py).

A block layout ``[H, nb, nb]`` (``sparsity_config.py``) names the
``block x block`` tiles of the attention matrix that are computed. It is
turned into look-up tables once per layout and device (:func:`sparse_luts`):
for each query block the ascending indices of its active key blocks, padded
with -1 to the widest row, and the transposed table for each key block.
Beside them, the number of active entries of every row, where the CUDA
kernels stop: with BigBird's or Longformer's global rows the padded width is
the whole sequence while the mean row holds a few blocks.

Three hand-written CUDA kernels in ``csrc/block_sparse.cu``, one wrapper
each, with a launch counter:

* :func:`block_sparse_fwd` (replaces ``_fwd_kernel``): flat ``[BH, T, Dh]``
  q/k/v → ``(out [BH, T, Dh], lse f32 [BH, T])``, an online softmax over the
  active key blocks of each query block;
* :func:`block_sparse_bwd_dq` (replaces ``_bwd_dq_kernel``) over the same
  table, from lse and ``delta = rowsum(dO * O)``;
* :func:`block_sparse_bwd_dkv` (replaces ``_bwd_dkv_kernel``) over the
  transposed table.

All three kernels run work lists built with the tables (:func:`work_list`):
each query block's row (the forward and dQ, one list) or key block's column
(dK/dV) is cut into parts of at most ``_PART`` entries, the parts sorted by
length so that the row groups of one CUDA block get near-equal work, and a
row or column cut in several parts is combined from f32 partials by a
second launch, in part order: the forward's parts leave their unnormalised
``acc`` with their running max ``m`` and sum ``l``, merged as
:func:`fwd_merge_plain` does; dQ's and dK/dV's are summed.

:func:`block_sparse_attention` on ``[B, T, H, Dh]`` wires them as a
``torch.autograd.Function``; delta stays plain torch, as the reference
computes it outside its kernels.

The numeric contract is the reference's, f32 throughout: q, k, v and dO are
read as f32, q is scaled in f32 before q.k^T, p and dS stay f32 (never
rounded to the storage dtype, unlike the flash kernels), dQ is scaled once
at the end and dK comes from dS^T.(scaled q). One departure, within the
tolerances the card checks hold: for bf16 and fp16 inputs the forward's
kernel forms q.k^T on the tensor cores from the stored values (exact in 16
bits, f32 accumulation) and scales the f32 score, so the scale rounds on the
score where the reference rounds it on q. Scores outside the layout, or
above the diagonal under ``causal`` (absolute positions), are -1e30 and give
p = 0. A row with no visible key (``causal`` over a bidirectional layout can
leave one) gives out 0 and lse -1e30 + log(1e-20), and contributes nothing
to the gradients.

CUDA tensors launch the kernels (bf16, fp16 and f32; block 16, 32 or 64; Dh
64 or 128; T a multiple of the block) or raise ``ValueError``. CPU tensors run the
plain versions, which take any block and head width (the reference's tests
use block 8). Each plain version walks the table's columns the way the TPU
grid's last axis does: one gathered K/V (or Q/dO) block for every
(bh, block) per step, so its memory stays O(T * Dh) whatever the width.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import cuda_build

_NEG_INF = -1e30
_PART = 64              # table entries per work item at most
_GROUP_ROWS = 64        # rows per CUDA block of the kernels
_BLOCKS = (16, 32, 64)
_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


# ------------------------------------------------------------------ layouts
def layout_to_dense_mask(layout: np.ndarray, block: int) -> np.ndarray:
    """[H, nb, nb] block layout → [H, T, T] boolean element mask."""
    return np.repeat(np.repeat(layout, block, axis=1), block, axis=2)


def _normalize_layout(layout) -> np.ndarray:
    """Dtype-normalize before hashing: raw-byte keys on an int/float layout
    would silently misparse into a garbage LUT."""
    return np.ascontiguousarray(np.asarray(layout) != 0)


def _active_lut(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per row of ``layout [H, R, C]``: its active column indices, ascending,
    padded with -1 to the widest row (at least 1), and their count."""
    count = layout.sum(axis=2, dtype=np.int32)
    width = max(1, int(count.max()))
    order = np.argsort(~layout, axis=2, kind="stable")[:, :, :width]
    lut = np.where(np.arange(width) < count[..., None], order, -1)
    return lut.astype(np.int32), count


def _build_luts(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """layout [H, nq, nk] → (lut_q [H, nq, A], lut_k [H, nk, B]) of active
    block indices padded with -1 (A/B = max row/col active count)."""
    return _active_lut(layout)[0], _active_lut(layout.transpose(0, 2, 1))[0]


def work_list(counts: np.ndarray, part: int = _PART):
    """A kernel's work, from the entry counts ``[H, nb]`` of its table's
    lines: the rows of the table for the forward and dQ (``cnt_q``), the
    columns, i.e. the rows of the transposed table, for dK/dV (``cnt_k``).

    Each line (head h, block i) is cut into parts of at most ``part``
    entries, in table order (an empty line is one empty part: its output
    block is zeros). Returns ``(items, merge, n_slots)``:

    * ``items`` int32 ``[n, 4]``: ``(h * nb + i, first entry, count,
      slot)``, sorted by descending count (ties in (h, i, part) order).
      The kernel's CUDA block j runs items ``j * G .. j * G + G - 1``, one
      per row group, so the longest blocks launch first. ``slot`` is -1
      for a line of one part (it writes its output itself), else the
      part's f32 partial in the scratch;
    * ``merge`` int32 ``[m, 4]``: ``(h * nb + i, first slot, parts, 0)``
      for each line of several parts, whose slots are consecutive in part
      order;
    * ``n_slots``: the number of partials."""
    lines = np.asarray(counts, dtype=np.int64).reshape(-1)
    n_parts = np.maximum(1, -(-lines // part))
    line = np.repeat(np.arange(lines.size), n_parts)
    index = np.arange(line.size) - np.repeat(np.cumsum(n_parts) - n_parts, n_parts)
    first = index * part
    count = np.minimum(part, lines[line] - first)
    split = n_parts[line] > 1
    slot = np.where(split, np.cumsum(split) - 1, -1)
    items = np.stack([line, first, count, slot], axis=1)
    items = items[np.argsort(-count, kind="stable")]
    split_lines = np.flatnonzero(n_parts > 1)
    merge = np.stack([split_lines, slot[first == 0][split_lines], n_parts[split_lines],
                      np.zeros_like(split_lines)], axis=1)
    return (items.astype(np.int32).reshape(-1, 4),
            merge.astype(np.int32).reshape(-1, 4), int(split.sum()))


def row_groups(block: int) -> int:
    """Row groups (one work item each) of a kernel's CUDA block."""
    return _GROUP_ROWS // block


def group_busy(counts, groups: int) -> float:
    """The share of row-group time that does work, for items run ``groups``
    to a CUDA block in the order given: for each CUDA block the sum of its
    groups' entry counts over ``groups`` x its largest count, averaged over
    the blocks weighted by that largest count (a block lasts as long as its
    longest group)."""
    c = np.asarray(counts, dtype=np.int64).reshape(-1)
    c = np.concatenate([c, np.zeros(-c.size % groups, np.int64)]).reshape(-1, groups)
    longest = c.max(axis=1).sum()
    return float(c.sum() / (groups * longest)) if longest else 1.0


class SparseLuts(NamedTuple):
    """Tables on one device: int32 ``lut_q [H, nb, A]`` and its row counts
    ``cnt_q [H, nb]``; the transposed ``lut_k [H, nb, Bc]`` and ``cnt_k``;
    the dQ work list over ``cnt_q`` (:func:`work_list`) ``dq_items``,
    ``dq_merge`` and its partial count ``dq_slots``; the dK/dV work list
    over ``cnt_k``, ``dkv_items``, ``dkv_merge`` and ``dkv_slots``. The
    forward walks the same table as dQ with the same row groups, so its
    list (``fwd_items``, ``fwd_merge``, ``fwd_slots``) is dQ's."""
    lut_q: torch.Tensor
    cnt_q: torch.Tensor
    lut_k: torch.Tensor
    cnt_k: torch.Tensor
    dq_items: torch.Tensor
    dq_merge: torch.Tensor
    dq_slots: int
    dkv_items: torch.Tensor
    dkv_merge: torch.Tensor
    dkv_slots: int

    @property
    def fwd_items(self) -> torch.Tensor:
        return self.dq_items

    @property
    def fwd_merge(self) -> torch.Tensor:
        return self.dq_merge

    @property
    def fwd_slots(self) -> int:
        return self.dq_slots


_TABLES = ("lut_q", "cnt_q", "lut_k", "cnt_k", "dq_items", "dq_merge",
           "dkv_items", "dkv_merge")


@functools.lru_cache(maxsize=64)
def _luts_cached(key: bytes, shape: Tuple[int, int, int], device: str):
    layout = np.frombuffer(key, dtype=bool).reshape(shape)
    lut_q, cnt_q = _active_lut(layout)
    lut_k, cnt_k = _active_lut(layout.transpose(0, 2, 1))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dq_items, dq_merge, dq_slots = work_list(cnt_q)
    dkv_items, dkv_merge, dkv_slots = work_list(cnt_k)
    return SparseLuts(dev(lut_q), dev(cnt_q), dev(lut_k), dev(cnt_k),
                      dev(dq_items), dev(dq_merge), dq_slots,
                      dev(dkv_items), dev(dkv_merge), dkv_slots)


def sparse_luts(layout, device) -> SparseLuts:
    """The tables of ``layout`` on ``device``, cached on the layout's bytes,
    shape and device: once warm, a call makes no host-to-device copy."""
    layout = _normalize_layout(layout)
    return _luts_cached(layout.tobytes(), layout.shape, str(torch.device(device)))


# ------------------------------------------------------------ plain versions
def _scale(scale, dh: int) -> float:
    return float(scale) if scale is not None else dh ** -0.5


def _blocks(x: torch.Tensor, h: int, block: int) -> torch.Tensor:
    """Flat ``[BH, T, Dh]`` → ``[B, H, nb, block, Dh]`` in f32 (in f64 for an
    f64 ``x``: the plain arithmetic at a higher precision, the yardstick of
    two f32 summation orders)."""
    bh, t, dh = x.shape
    x = x if x.dtype == torch.float64 else x.float()
    return x.reshape(bh // h, h, t // block, block, dh)


def _rows(x: torch.Tensor, h: int, block: int) -> torch.Tensor:
    """Flat ``[BH, T]`` → ``[B, H, nb, block]``."""
    bh, t = x.shape
    return x.reshape(bh // h, h, t // block, block)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Blocks ``x[b, h, idx[h, i]]`` for every (b, h, i): ``x`` is ``[B, H,
    nb, ...]``, ``idx`` ``[H, nb]`` (already clamped to >= 0)."""
    shape = (x.shape[0],) + tuple(idx.shape) + tuple(x.shape[3:])
    view = idx.long().reshape((1,) + tuple(idx.shape) + (1,) * (x.dim() - 3))
    return torch.gather(x, 2, view.expand(shape))


def _masked_scores(q, kb, col, qi_pos, kj, block: int, causal: bool):
    """``q . kb^T`` ``[B, H, nb, block, block]`` with the padding entries of
    this table column (``kj < 0``) and, under ``causal``, keys past the query
    (absolute positions) set to -1e30. ``qi_pos`` are the absolute query
    rows of the blocks whose keys are ``kj``."""
    s = torch.matmul(q, kb.transpose(-1, -2))
    keep = (kj >= 0)[None, :, :, None, None]
    if causal:
        k_pos = kj.clamp_min(0)[..., None] * block + col            # [H, nb, blk]
        keep = keep & (k_pos[:, :, None, :] <= qi_pos[..., None])[None]
    return s.masked_fill(~keep, _NEG_INF)


def _masked_p(s, ref):
    """exp(s - ref) with fully-masked entries forced to 0 (an all-masked row
    would otherwise read exp(-inf + inf) = 1 and leak block-0 values)."""
    return torch.where(s > _NEG_INF * 0.5, torch.exp(s - ref), 0.0)


def _positions(luts: SparseLuts, block: int, device):
    """Absolute row positions ``[nb, block]`` and in-block columns."""
    nb = luts.lut_q.shape[1]
    col = torch.arange(block, device=device)
    return torch.arange(nb, device=device)[:, None] * block + col, col


def _fwd_state(qf, kf, vf, luts: SparseLuts, *, block: int, causal: bool,
               scale: Optional[float] = None):
    """The forward's online softmax over the table's columns, before the
    division: ``(acc [B, H, nb, block, Dh], m, l [B, H, nb, block])``."""
    h = luts.lut_q.shape[0]
    sc = _scale(scale, qf.shape[-1])
    q = _blocks(qf, h, block) * sc
    k, v = _blocks(kf, h, block), _blocks(vf, h, block)
    pos, col = _positions(luts, block, qf.device)
    m = torch.full(q.shape[:-1], _NEG_INF, device=qf.device, dtype=q.dtype)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for j in range(luts.lut_q.shape[2]):
        kj = luts.lut_q[:, :, j]
        kjc = kj.clamp_min(0)
        s = _masked_scores(q, _gather(k, kjc), col, pos, kj, block, causal)
        m_new = torch.maximum(m, s.amax(-1))
        p = _masked_p(s, m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p, _gather(v, kjc))
        m = m_new
    return acc, m, l


def _fwd_finish(acc, m, l, qf):
    """``out = acc / max(l, 1e-20)`` (0 where ``l`` is 0), cast once, and
    ``lse = m + log(max(l, 1e-20))``, on flat shapes."""
    l_safe = l.clamp_min(1e-20)
    out = torch.where(l[..., None] > 0, acc / l_safe[..., None], 0.0)
    return (out.reshape(qf.shape).to(qf.dtype),
            (m + torch.log(l_safe)).reshape(qf.shape[:2]))


def fwd_merge_plain(states):
    """The forward merge of a cut row's parts, ``[(acc, m, l), ...]`` in part
    order, as ``block_sparse_fwd_merge`` computes it: ``M = max m_j``, ``L =
    sum e^(m_j - M) l_j``, ``acc = sum e^(m_j - M) acc_j``. A part that saw
    no key (``m`` -1e30, ``l`` 0, ``acc`` 0) adds nothing."""
    mm = states[0][1]
    for _, m, _ in states[1:]:
        mm = torch.maximum(mm, m)
    acc, ll = 0.0, 0.0
    for a, m, l in states:
        w = torch.exp(m - mm)
        ll = ll + w * l
        acc = acc + w[..., None] * a
    return acc, mm, ll


def block_sparse_fwd_plain(qf, kf, vf, luts: SparseLuts, *, block: int,
                           causal: bool, scale: Optional[float] = None):
    """Plain version of :func:`block_sparse_fwd`."""
    return _fwd_finish(*_fwd_state(qf, kf, vf, luts, block=block,
                                   causal=causal, scale=scale), qf)


def block_sparse_bwd_dq_plain(qf, kf, vf, dof, lse, delta, luts: SparseLuts, *,
                              block: int, causal: bool,
                              scale: Optional[float] = None):
    """Plain version of :func:`block_sparse_bwd_dq`."""
    h = luts.lut_q.shape[0]
    sc = _scale(scale, qf.shape[-1])
    q = _blocks(qf, h, block) * sc
    do = _blocks(dof, h, block)
    k, v = _blocks(kf, h, block), _blocks(vf, h, block)
    lse_b, delta_b = _rows(lse, h, block)[..., None], _rows(delta, h, block)[..., None]
    pos, col = _positions(luts, block, qf.device)
    acc = torch.zeros_like(q)
    for j in range(luts.lut_q.shape[2]):
        kj = luts.lut_q[:, :, j]
        kjc = kj.clamp_min(0)
        kb = _gather(k, kjc)
        p = _masked_p(_masked_scores(q, kb, col, pos, kj, block, causal), lse_b)
        dp = torch.matmul(do, _gather(v, kjc).transpose(-1, -2))
        acc = acc + torch.matmul(p * (dp - delta_b), kb)
    return (acc * sc).reshape(qf.shape).to(qf.dtype)


def block_sparse_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, luts: SparseLuts, *,
                               block: int, causal: bool,
                               scale: Optional[float] = None):
    """Plain version of :func:`block_sparse_bwd_dkv`: for each key block the
    query blocks of the transposed table, ``[query rows, key cols]`` scores
    as in the forward."""
    h = luts.lut_k.shape[0]
    sc = _scale(scale, qf.shape[-1])
    q = _blocks(qf, h, block) * sc
    do = _blocks(dof, h, block)
    k, v = _blocks(kf, h, block), _blocks(vf, h, block)
    lse_b, delta_b = _rows(lse, h, block), _rows(delta, h, block)
    nb = luts.lut_k.shape[1]
    col = torch.arange(block, device=qf.device)
    k_pos = torch.arange(nb, device=qf.device)[:, None] * block + col  # [nb, blk]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j in range(luts.lut_k.shape[2]):
        qi = luts.lut_k[:, :, j]                                    # [H, nb]
        qic = qi.clamp_min(0)
        qb, dob = _gather(q, qic), _gather(do, qic)
        s = torch.matmul(qb, k.transpose(-1, -2))                   # [.., q, k]
        keep = (qi >= 0)[None, :, :, None, None]
        if causal:
            q_pos = qic[..., None] * block + col                    # [H, nb, blk]
            keep = keep & (k_pos[None, :, None, :] <= q_pos[..., None])[None]
        s = s.masked_fill(~keep, _NEG_INF)
        p = _masked_p(s, _gather(lse_b, qic)[..., None])
        dv = dv + torch.matmul(p.transpose(-1, -2), dob)
        dp = torch.matmul(dob, v.transpose(-1, -2))
        ds = p * (dp - _gather(delta_b, qic)[..., None])
        dk = dk + torch.matmul(ds.transpose(-1, -2), qb)
    return dk.reshape(kf.shape).to(kf.dtype), dv.reshape(vf.shape).to(vf.dtype)


# ---------------------------------------------------------------- wrappers
def _check(what: str, luts: SparseLuts, block: int, tensors) -> Tuple[int, ...]:
    """Validate flat CUDA operands; returns ``(bh, h, t, dh)``."""
    qf = tensors[0][1]
    if qf.ndim != 3:
        raise ValueError(f"{what}: q {tuple(qf.shape)} is not a flat [BH, T, Dh] "
                         "operand")
    bh, t, dh = qf.shape
    h, nb = luts.lut_q.shape[:2]
    if (block not in _BLOCKS or dh not in _HEAD_DIMS or qf.dtype not in _DTYPES
            or t % block or t // block != nb or bh % h or not 0 < bh <= 65535):
        raise ValueError(
            f"{what}: unsupported geometry BH={bh} T={t} Dh={dh} block={block} "
            f"{qf.dtype} with a [{h}, {nb}, {nb}] layout (block in {_BLOCKS}, "
            f"Dh in {_HEAD_DIMS}, bf16/fp16/f32, T = nb * block, BH a multiple "
            "of H)")
    for name, x in tensors:
        rows = name in ("lse", "delta")
        want = (bh, t) if rows else (bh, t, dh)
        dtype = torch.float32 if rows else qf.dtype
        if tuple(x.shape) != want or x.dtype != dtype or x.device != qf.device:
            raise ValueError(f"{what}: {name} {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}, want {want} {dtype} on {qf.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             "aligned")
    for name in _TABLES:
        x = getattr(luts, name)
        if x.device != qf.device or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{what}: table {name} must be contiguous int32 on "
                             f"{qf.device}")
    return bh, h, t, dh


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _cuda_only(what: str, qf) -> None:
    if qf.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qf.device}")


def block_sparse_fwd(qf, kf, vf, luts: SparseLuts, *, block: int, causal: bool,
                     scale: Optional[float] = None):
    """Kernel-level forward on flat operands: q/k/v ``[BH, T, Dh]`` →
    ``(out [BH, T, Dh], lse f32 [BH, T])``, from the cached work list (cut
    rows through f32 partials from ``torch.empty``, merged by a second
    launch)."""
    if qf.device.type == "cpu":
        return block_sparse_fwd_plain(qf, kf, vf, luts, block=block,
                                      causal=causal, scale=scale)
    _cuda_only("block_sparse_fwd", qf)
    bh, h, t, dh = _check("block_sparse_fwd", luts, block,
                          (("q", qf), ("k", kf), ("v", vf)))
    lib = cuda_build.kernels()
    out = torch.empty_like(qf)
    lse = torch.empty((bh, t), dtype=torch.float32, device=qf.device)
    part = None
    if luts.fwd_slots:
        part = torch.empty((bh // h, luts.fwd_slots, block * (dh + 2)),
                           dtype=torch.float32, device=qf.device)
    err = lib.dst_block_sparse_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
        lse.data_ptr(), luts.lut_q.data_ptr(), luts.fwd_items.data_ptr(),
        luts.fwd_merge.data_ptr(), None if part is None else part.data_ptr(),
        luts.fwd_items.shape[0], luts.fwd_merge.shape[0], luts.fwd_slots,
        bh, h, t, dh, block, luts.lut_q.shape[2], int(bool(causal)),
        _scale(scale, dh), cuda_build.dtype_code(qf.dtype), _stream(qf))
    cuda_build.check(lib, err, "block_sparse_fwd")
    block_sparse_fwd.launches += 1
    return out, lse


block_sparse_fwd.launches = 0


def _bwd_operands(qf, kf, vf, dof, lse, delta):
    return (("q", qf), ("k", kf), ("v", vf), ("dout", dof), ("lse", lse),
            ("delta", delta))


def block_sparse_bwd_dq(qf, kf, vf, dof, lse, delta, luts: SparseLuts, *,
                        block: int, causal: bool, scale: Optional[float] = None):
    """Backward dQ ``[BH, T, Dh]`` from lse and ``delta = rowsum(dO * O)``
    (f32 ``[BH, T]``), from the cached work list (cut rows through f32
    partials from ``torch.empty``, summed by a second launch)."""
    if qf.device.type == "cpu":
        return block_sparse_bwd_dq_plain(qf, kf, vf, dof, lse, delta, luts,
                                         block=block, causal=causal, scale=scale)
    _cuda_only("block_sparse_bwd_dq", qf)
    bh, h, t, dh = _check("block_sparse_bwd_dq", luts, block,
                          _bwd_operands(qf, kf, vf, dof, lse, delta))
    lib = cuda_build.kernels()
    dq = torch.empty_like(qf)
    part = None
    if luts.dq_slots:
        part = torch.empty((bh // h, luts.dq_slots, block, dh),
                           dtype=torch.float32, device=qf.device)
    err = lib.dst_block_sparse_bwd_dq(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), luts.lut_q.data_ptr(),
        luts.dq_items.data_ptr(), luts.dq_merge.data_ptr(),
        None if part is None else part.data_ptr(), luts.dq_items.shape[0],
        luts.dq_merge.shape[0], luts.dq_slots, bh, h, t, dh, block,
        luts.lut_q.shape[2], int(bool(causal)), _scale(scale, dh),
        cuda_build.dtype_code(qf.dtype), _stream(qf))
    cuda_build.check(lib, err, "block_sparse_bwd_dq")
    block_sparse_bwd_dq.launches += 1
    return dq


block_sparse_bwd_dq.launches = 0


def block_sparse_bwd_dkv(qf, kf, vf, dof, lse, delta, luts: SparseLuts, *,
                         block: int, causal: bool,
                         scale: Optional[float] = None):
    """Backward ``(dK, dV)``, each ``[BH, T, Dh]``, over the transposed
    table, from the cached work list (split columns through f32 partials
    from ``torch.empty``, summed by a second launch)."""
    if qf.device.type == "cpu":
        return block_sparse_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, luts,
                                          block=block, causal=causal,
                                          scale=scale)
    _cuda_only("block_sparse_bwd_dkv", qf)
    bh, h, t, dh = _check("block_sparse_bwd_dkv", luts, block,
                          _bwd_operands(qf, kf, vf, dof, lse, delta))
    lib = cuda_build.kernels()
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    part = None
    if luts.dkv_slots:
        part = torch.empty((bh // h, luts.dkv_slots, 2, block, dh),
                           dtype=torch.float32, device=qf.device)
    err = lib.dst_block_sparse_bwd_dkv(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), dof.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        luts.lut_k.data_ptr(), luts.dkv_items.data_ptr(),
        luts.dkv_merge.data_ptr(), None if part is None else part.data_ptr(),
        luts.dkv_items.shape[0], luts.dkv_merge.shape[0], luts.dkv_slots,
        bh, h, t, dh, block, luts.lut_k.shape[2], int(bool(causal)),
        _scale(scale, dh), cuda_build.dtype_code(qf.dtype), _stream(qf))
    cuda_build.check(lib, err, "block_sparse_bwd_dkv")
    block_sparse_bwd_dkv.launches += 1
    return dk, dv


block_sparse_bwd_dkv.launches = 0


def block_sparse_delta(dof, out):
    """``rowsum(dO * O)`` in f32, ``[BH, T]`` (plain torch, as in the
    reference)."""
    return (dof.float() * out.float()).sum(-1)


# ------------------------------------------------------- [B, T, H, Dh] op
def _reshape_bh(x):
    b, t, h, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, dh).contiguous()


def _unshape_bh(x, b: int, h: int):
    bh, t, dh = x.shape
    return x.reshape(b, h, t, dh).permute(0, 2, 1, 3)


class _BlockSparseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, layout, block: int, causal: bool, scale):
        b, t, h, _ = q.shape
        layout = _normalize_layout(layout)
        if layout.shape != (h, t // block, t // block) or t % block:
            raise ValueError(f"layout {layout.shape} != ({h}, {t // block}, "
                             f"{t // block}) for T={t}, block={block}")
        luts = sparse_luts(layout, q.device)
        qf, kf, vf = _reshape_bh(q), _reshape_bh(k), _reshape_bh(v)
        out, lse = block_sparse_fwd(qf, kf, vf, luts, block=block,
                                    causal=causal, scale=scale)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.luts, ctx.block, ctx.causal, ctx.scale = luts, block, causal, scale
        ctx.bh = (b, h)
        return _unshape_bh(out, b, h)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        b, h = ctx.bh
        dof = _reshape_bh(g.to(qf.dtype))
        delta = block_sparse_delta(dof, out)
        kw = dict(block=ctx.block, causal=ctx.causal, scale=ctx.scale)
        dq = block_sparse_bwd_dq(qf, kf, vf, dof, lse, delta, ctx.luts, **kw)
        dk, dv = block_sparse_bwd_dkv(qf, kf, vf, dof, lse, delta, ctx.luts, **kw)
        return (_unshape_bh(dq, b, h), _unshape_bh(dk, b, h),
                _unshape_bh(dv, b, h), None, None, None, None)


def block_sparse_attention(q, k, v, layout, block: int = 16,
                           causal: bool = False,
                           scale: Optional[float] = None):
    """q/k/v: [B, T, H, Dh]; ``layout``: STATIC numpy [H, T//block, T//block]
    bool (hash-keyed for the LUT cache — pass the array from a
    SparsityConfig). Differentiable through the backward kernels."""
    return _BlockSparseAttention.apply(q, k, v, layout, block, causal, scale)


# ---------------------------------------------------------- dense oracle
def block_sparse_attention_reference(q, k, v, layout, block: int = 16,
                                     causal: bool = False,
                                     scale: Optional[float] = None):
    """Dense masked-softmax oracle (numerics ground truth for tests)."""
    b, t, h, dh = q.shape
    sc = _scale(scale, dh)
    lay = torch.from_numpy(_normalize_layout(layout)).to(q.device)
    mask = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        mask = mask & torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    qf = q.permute(0, 2, 1, 3).float() * sc                   # [B, H, T, Dh]
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    s = torch.matmul(qf, kf.transpose(-1, -2)).masked_fill(~mask[None], _NEG_INF)
    o = torch.matmul(torch.softmax(s, dim=-1), vf)
    # rows the layout masks entirely produce zeros (kernel semantics), not a
    # uniform average
    o = torch.where(mask.any(-1)[None, :, :, None], o, 0.0)
    return o.permute(0, 2, 1, 3).to(q.dtype)
