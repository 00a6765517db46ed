"""Kernel C: fused block gather + score, the graph beam's frontier scorer.

Port of ``redis_hnsw_tpu/ops/pallas_gather.py::fused_block_score`` (the
Pallas TPU kernel at pallas_gather.py:98, its pallas_call at :109). For
lane b and candidate e of ``cand`` [B, E], with x the f-th row of the
candidate's neighbour block ``nbrvec[cand[b, e]]``:

    sims[b, e*F + f] = ((2 * q[b].x) - qn[b]) - nbrsqn[cand[b, e], f]

``nbrsqn`` is each neighbour's exact f32 sqnorm, so the kernel computes
the JAX package's default scorer (ops/distance.py ``block_neg_sq_l2``)
without its mask; the caller applies ``where(fresh, sims, -inf)``.

* On a CUDA tensor, :func:`fused_block_score` launches the hand-written
  CUDA kernel ``csrc/block_score.cu`` or raises -- there is no fallback.
* On a CPU tensor it runs :func:`plain_block_score`, the kernel's
  reference in the tests.

:func:`fused_row_score` is the same function on a row table (F = 1):
on the card the beam scores its entry point, seeds and row-gathered
frontiers through it, so every sim of a node -- from a block or a row --
is one thread's identical f32 arithmetic (csrc/block_score.cu).

Bound on the H100: each (b, e) reads one [F, D] block (537 MB in f32 at
B=2048, E=16, F=32, D=128), so it is bound by HBM bytes; the design (a
ring of bulk asynchronous copies a warp) is in csrc/block_score.cu, its
time beside that bound in PERF.md, measured by chip_smoke.py.
:func:`plan` picks the kernel's form and its persistent grid.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter, namedtuple

import torch

from . import distance as D

# Rows a block the kernel takes: F <= MAX_F.
MAX_F = 256

# The kernel's forms (csrc/block_score.cu): the general form, one
# thread an output reading its row straight from the table; 32 rows of a
# block a warp, one bulk copy an item; 32 outputs of the flattened
# [B, E*F] a warp, one bulk copy a row.
DIRECT, BLOCK, ROWS = 0, 1, 2
FORM_NAMES = ("direct", "block", "rows")
LANES = 32           # rows an item, one a lane
MAX_WARPS = 16       # warps a thread block (BS_MAX_WARPS)
MAX_RING = 16        # stages a warp (BS_MAX_RING)
HDR = MAX_WARPS * MAX_RING * 8   # mbarriers, bytes
MAX_SMEM = 232448    # dynamic shared memory a thread block
SMEM_BUDGET = 200 * 1024  # shared memory planned for one block a SM
DIRECT_THREADS = 256
BLOCK_MIN_F = 16     # blocks of fewer rows take the row-copy form

Plan = namedtuple("Plan", "form warps ring grid per_warp")

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_operands(q, qn, nbrvec, nbrsqn, cand):
    """Validate kernel C's operands; raises on what it does not take."""
    if q.dim() != 2 or nbrvec.dim() != 3 or cand.dim() != 2:
        raise ValueError("q [B, D], nbrvec [N, F, D], cand [B, E] expected")
    B, Dw = q.shape
    N, F, Dn = nbrvec.shape
    if Dn != Dw:
        raise ValueError(f"query width {Dw} != block width {Dn}")
    if tuple(qn.shape) != (B,) or tuple(cand.shape[:1]) != (B,):
        raise ValueError("qn must be [B] and cand [B, E]")
    if tuple(nbrsqn.shape) != (N, F):
        raise ValueError("nbrsqn must be [N, F]")
    if nbrvec.dtype not in _DTYPES:
        raise TypeError(
            f"block scoring takes f32/f16/bf16 blocks, got {nbrvec.dtype}"
        )
    for t in (q, qn, nbrsqn):
        if t.dtype != torch.float32:
            raise TypeError(f"q, qn and nbrsqn must be float32, got {t.dtype}")
    if cand.dtype != torch.int32:
        raise TypeError(f"cand must be int32, got {cand.dtype}")
    if F > MAX_F:
        raise ValueError(f"block scoring supports F <= {MAX_F}, got {F}")
    for t in (qn, nbrvec, nbrsqn, cand):
        if t.device != q.device:
            raise ValueError("all operands must be on one device")


def plain_block_score(q, qn, nbrvec, nbrsqn, cand):
    """Plain PyTorch version of :func:`fused_block_score`
    (= ops/distance.py ``block_neg_sq_l2`` with nothing masked)."""
    B, E = cand.shape
    everything = torch.ones((B, E * nbrvec.shape[1]), dtype=torch.bool,
                            device=q.device)
    return D.block_neg_sq_l2(q, qn, nbrvec, nbrsqn, cand, everything)


def stage_bytes(form, D, elem):
    """Bytes of one ring stage, rounded up to 128 (csrc/block_score.cu
    bs_stage_bytes): the block form's 32 rows and q[b] after them; the
    row form's 32 rows an odd number of 16-byte units apart and a byte a
    lane naming the lane whose copy it reads."""
    if form == BLOCK:
        raw = LANES * D * elem + D * 4
    else:
        raw = LANES * ((D * elem // 16) | 1) * 16 + LANES
    return -(-raw // 128) * 128


def smem_bytes(form, D, elem, warps, ring):
    """A thread block's dynamic shared memory: the barriers and the
    warps' rings (csrc/block_score.cu bs_smem_bytes)."""
    return HDR + warps * ring * stage_bytes(form, D, elem)


@functools.lru_cache(maxsize=512)
def plan(sms, B, E, F, D, elem, aligned):
    """The kernel's form and launch for one call on a card of ``sms``
    SMs. ``aligned``: q and nbrvec start on 16-byte boundaries. Rows of
    whole 16-byte steps take a bulk form: blocks of F >= BLOCK_MIN_F rows
    the block form, anything else the row form. One block a SM holds as
    many warps as SMEM_BUDGET has stages for (up to MAX_WARPS), each with
    as many stages as then fit: the study (tools/block_score_study.cu)
    found the time set by the warps scoring at once, not by the stages a
    warp keeps in flight. The items (32 rows each) are spread evenly over
    the warps, on as many SMs as there is work for. Anything else, or a
    stage that does not fit, takes the general form."""
    rows = B * E * F
    form = BLOCK if F >= BLOCK_MIN_F else ROWS
    st = stage_bytes(form, D, elem)
    room = SMEM_BUDGET - HDR
    if not aligned or D * elem % 16 or st > room:
        grid = max(1, min(-(-rows // DIRECT_THREADS), sms * 8))
        return Plan(DIRECT, 0, 0, grid, 0)
    warps = min(MAX_WARPS, room // st)
    ring = min(MAX_RING, room // (warps * st))
    if form == BLOCK:
        items = B * E * -(-F // LANES)
    else:
        items = -(-rows // LANES)
    per_warp = -(-items // (sms * warps))
    busy = -(-items // per_warp)          # warps with work
    warps = min(warps, -(-busy // sms))   # spread them over the SMs
    return Plan(form, warps, ring, -(-busy // warps), per_warp)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry, its argument types set once: the beam launches kernel
    C dozens of times a batch, and it is host-bound."""
    from ..utils.build import load_kernel

    fn = load_kernel("block_score").block_score_launch
    fn.restype = _I
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_longlong, _P, _P]
    return fn


# fused_block_score.forms' keys, by (F == 1, form)
_FORM_KEYS = {(row, form): f"{'row' if row else 'block'}/{name}"
              for row in (False, True) for form, name in enumerate(FORM_NAMES)}


def fused_block_score(q, qn, nbrvec, nbrsqn, cand):
    """[B, E*F] f32 matmul-form sims of every candidate's neighbour
    block. ``q`` [B, D] f32, ``qn`` [B] f32 query sqnorms, ``nbrvec``
    [N, F, D] f32/f16/bf16, ``nbrsqn`` [N, F] f32, ``cand`` [B, E] int32
    (in range: clamp before calling). A CUDA tensor launches kernel C; a
    CPU tensor takes the plain version."""
    check_operands(q, qn, nbrvec, nbrsqn, cand)
    if q.device.type == "cpu":
        return plain_block_score(q, qn, nbrvec, nbrsqn, cand)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, qn, nbrvec, nbrsqn, cand = (
        t.contiguous() for t in (q, qn, nbrvec, nbrsqn, cand)
    )
    B, E = cand.shape
    F, Dw = nbrvec.shape[1], nbrvec.shape[2]
    out = torch.empty((B, E * F), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    index = q.device.index
    if index is None:
        index = torch.cuda.current_device()
    aligned = q.data_ptr() % 16 == 0 and nbrvec.data_ptr() % 16 == 0
    p = plan(_sm_count(index), B, E, F, Dw, nbrvec.element_size(), aligned)
    launch = _kernel()
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), qn.data_ptr(), nbrvec.data_ptr(),
            nbrsqn.data_ptr(), cand.data_ptr(), B, E, F, Dw,
            _DTYPES[nbrvec.dtype], p.form, p.warps, p.ring, p.grid,
            p.per_warp, out.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"block_score kernel launch failed: CUDA error {err}")
    fused_block_score.launches += 1
    fused_block_score.forms[_FORM_KEYS[F == 1, p.form]] += 1
    return out


# Launches of the CUDA kernel in this process (plain-version calls on the
# CPU do not count). chip_smoke.py resets and reads it around the main path.
fused_block_score.launches = 0
# The same launches by call ("row": F = 1, the row form; "block") and by
# the kernel's form that ran, e.g. "block/block", "row/rows", "row/direct".
fused_block_score.forms = Counter()


def fused_row_score(q, qn, vecs, sqn, ids):
    """[B, J] sims of rows ``ids`` [B, J] (int32, in range) of the table
    ``vecs`` [N, D] with sqnorms ``sqn`` [N]: kernel C on the table seen
    as one-row blocks, so a row scores exactly as it does in a block."""
    return fused_block_score(q, qn, vecs.unsqueeze(1), sqn.unsqueeze(1), ids)
