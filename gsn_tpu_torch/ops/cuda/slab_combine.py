"""Sorted segment sum: kernel K3 (``csrc/segment_sum.cu``).

Counterpart of ``gsn_tpu/ops/pallas/slab_combine.py``.  The TPU's
``slab_combine_sum`` reduced per-chunk slabs into node rows by key; on
Hopper there are no slabs, and what remains of that function is a sum of
rows into sorted segments: ``out[k] = Σ_{i∈[ptr[k], ptr[k+1])}
rows[perm[i]]`` (``perm`` optional).  It carries the sender-side dB of
the edge message backward and the graph readout's forward.

Rows are f32 or bf16; the sum accumulates in f32 and is rounded once to
``out_dtype``: f32 → f32, bf16 → f32 (the pools), bf16 → bf16 (dB) or
f32 → bf16 (dB of the fused-BN moments pass, whose dH is f32).

K3 has two forms (``csrc/segment_sum.cu``): ``"warp"`` gives each
segment a warp and adds its rows in their order; ``"block"`` gives each
segment a block of 8 warps, whose partial sums meet in a fixed order.
``segment_sum_form`` picks one from the shape alone, and
``segment_sum_sorted`` launches that one.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build

# the data dtypes K1–K4 take
DATA_DTYPES = (torch.float32, torch.bfloat16)
# K3's forms, by the code its C entry points take
FORMS = {"warp": 0, "block": 1}
# the block form's rule (see segment_sum_form)
SMS = 132                  # an H100 SXM's streaming multiprocessors
BLOCKS_PER_SM = 8          # blocks of 256 threads an SM holds at once
BLOCK_MIN_ROWS = 16        # rows a segment needs on average


def segment_sum_form(n_seg: int, n_rows: int) -> str:
    """K3's form for ``n_seg`` segments over at most ``n_rows`` rows (the
    rows tensor's, or ``perm``'s, length: the host knows it without
    reading ``ptr``).

    ``"block"`` when the segments are few and long: at most one wave of
    resident blocks (SMS * BLOCKS_PER_SM), and at least BLOCK_MIN_ROWS
    rows a segment on average, so each of a block's 8 warps has rows to
    add.  One warp a segment would then leave most of the card idle and
    make each lane wait on every row of its segment in turn.  Else
    ``"warp"``: many segments fill the card with warps, and short ones
    give a block's warps nothing to share.  zinc-cli's pool (128 graphs
    over 5,504 node slots) takes the block form; its message sums (5,504
    receivers over 13,184 edge slots) and dB (5,504 senders over the
    13,184 slots of ``send_perm``, 7,360 of them real edges) the warp
    form."""
    for name, n in (("n_seg", n_seg), ("n_rows", n_rows)):
        if isinstance(n, bool) or not isinstance(n, int) or n < 0:
            raise ValueError(f"segment_sum_form: {name} must be an int >= "
                             f"0, got {n!r}")
    if 0 < n_seg <= SMS * BLOCKS_PER_SM and n_rows >= BLOCK_MIN_ROWS * n_seg:
        return "block"
    return "warp"


def segment_sum_sorted_plain(rows: torch.Tensor, ptr: torch.Tensor,
                             perm: Optional[torch.Tensor] = None,
                             out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Plain PyTorch version of K3 (the CPU path and the kernel's
    reference): an f32 sum, rounded once to ``out_dtype``."""
    n_seg = ptr.numel() - 1
    lengths = ptr.diff()
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=rows.device), lengths)
    pos = torch.arange(int(ptr[0]), int(ptr[-1]), device=rows.device)
    idx = perm[pos] if perm is not None else pos
    out = torch.zeros(n_seg, rows.shape[1], dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, seg, rows[idx].float()).to(out_dtype)


@build.counted
def segment_sum_sorted(rows: torch.Tensor, ptr: torch.Tensor,
                       perm: Optional[torch.Tensor] = None,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """[num_segments, d] sums of ``rows`` [R, d] over the CSR segments
    ``ptr`` [num_segments+1] (int32), through ``perm`` (int32, positions
    -> row ids) when given; accumulated in f32 and rounded once to
    ``out_dtype``.  CPU tensors take the plain version; CUDA tensors
    launch K3 (f32 or bf16 rows, f32 or bf16 out) in the form
    ``segment_sum_form`` picks."""
    if not build.on_cuda(rows):
        return segment_sum_sorted_plain(rows, ptr, perm, out_dtype)
    n_rows = perm.numel() if perm is not None else rows.shape[0]
    return segment_sum_sorted_in(
        segment_sum_form(ptr.numel() - 1, n_rows), rows, ptr, perm,
        out_dtype)


def segment_sum_sorted_in(form: str, rows: torch.Tensor, ptr: torch.Tensor,
                          perm: Optional[torch.Tensor] = None,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """K3 in the given form (``"warp"`` or ``"block"``) on CUDA tensors:
    what ``segment_sum_sorted`` launches, for checking each form."""
    if form not in FORMS:
        raise ValueError(f"segment_sum_sorted: form {form!r}, the kernel "
                         f"has {tuple(FORMS)}")
    if not build.on_cuda(rows):
        raise ValueError("segment_sum_sorted_in: the kernel's forms take "
                         "CUDA tensors")
    build.require("segment_sum_sorted", rows.device, rows,
                  dtype=DATA_DTYPES)
    build.require("segment_sum_sorted", rows.device, ptr, perm,
                  dtype=torch.int32)
    bf16_rows = rows.dtype == torch.bfloat16
    if out_dtype not in DATA_DTYPES:
        raise TypeError(f"segment_sum_sorted: out dtype "
                        f"{build.dtype_name(out_dtype)} from "
                        f"{build.dtype_name(rows.dtype)} rows; the kernel "
                        f"sums f32 or bf16 rows into f32 or bf16")
    if rows.dim() != 2:
        raise ValueError("segment_sum_sorted: rows must be [R, d]")
    n_seg, d = ptr.numel() - 1, rows.shape[1]
    out = torch.empty(n_seg, d, dtype=out_dtype, device=rows.device)
    if n_seg == 0 or d == 0:
        return out
    lib = build.lib("segment_sum")
    args = (build.ptr(rows), build.ptr(ptr), build.ptr(perm),
            build.ptr(out), n_seg, d)
    tail = (FORMS[form], build.stream_ptr(rows.device))
    if bf16_rows:
        rc = lib.gsn_segment_sum_sorted_bf16(
            *args, int(out_dtype == torch.bfloat16), *tail)
    elif out_dtype == torch.bfloat16:
        rc = lib.gsn_segment_sum_sorted_f32_bf16(*args, *tail)
    else:
        rc = lib.gsn_segment_sum_sorted(*args, *tail)
    build.check(rc, "segment_sum_sorted")
    build.count(segment_sum_sorted, f"{build.dtype_name(rows.dtype)}->"
                                    f"{build.dtype_name(out_dtype)}", form)
    return out
