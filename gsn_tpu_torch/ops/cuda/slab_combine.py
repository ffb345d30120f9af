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
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build

# the data dtypes K1–K4 take
DATA_DTYPES = (torch.float32, torch.bfloat16)


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
    launch K3 (f32 or bf16 rows, f32 or bf16 out)."""
    if not build.on_cuda(rows):
        return segment_sum_sorted_plain(rows, ptr, perm, out_dtype)
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
    stream = build.stream_ptr(rows.device)
    if bf16_rows:
        rc = lib.gsn_segment_sum_sorted_bf16(
            *args, int(out_dtype == torch.bfloat16), stream)
    elif out_dtype == torch.bfloat16:
        rc = lib.gsn_segment_sum_sorted_f32_bf16(*args, stream)
    else:
        rc = lib.gsn_segment_sum_sorted(*args, stream)
    build.check(rc, "segment_sum_sorted")
    build.count(segment_sum_sorted, f"{build.dtype_name(rows.dtype)}->"
                                    f"{build.dtype_name(out_dtype)}")
    return out
