"""Sorted segment sum: kernel K3 (``csrc/segment_sum.cu``).

Counterpart of ``gsn_tpu/ops/pallas/slab_combine.py``.  The TPU's
``slab_combine_sum`` reduced per-chunk slabs into node rows by key; on
Hopper there are no slabs, and what remains of that function is a sum of
rows into sorted segments: ``out[k] = Σ_{i∈[ptr[k], ptr[k+1])}
rows[perm[i]]`` (``perm`` optional).  It carries the sender-side dB of
the edge message backward and the graph readout's forward.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build


def segment_sum_sorted_plain(rows: torch.Tensor, ptr: torch.Tensor,
                             perm: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch version of K3 (the CPU path and the kernel's
    reference)."""
    n_seg = ptr.numel() - 1
    lengths = ptr.diff()
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=rows.device), lengths)
    pos = torch.arange(int(ptr[0]), int(ptr[-1]), device=rows.device)
    idx = perm[pos] if perm is not None else pos
    out = torch.zeros(n_seg, rows.shape[1], dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, seg, rows[idx].float())


def segment_sum_sorted(rows: torch.Tensor, ptr: torch.Tensor,
                       perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[num_segments, d] f32 sums of ``rows`` [R, d] over the CSR
    segments ``ptr`` [num_segments+1] (int32), through ``perm`` (int32,
    positions -> row ids) when given.  CPU tensors take the plain
    version; CUDA tensors launch K3 (f32 only)."""
    if not build.on_cuda(rows):
        return segment_sum_sorted_plain(rows, ptr, perm)
    build.require("segment_sum_sorted", rows.device, rows,
                  dtype=torch.float32)
    build.require("segment_sum_sorted", rows.device, ptr, perm,
                  dtype=torch.int32)
    if rows.dim() != 2:
        raise ValueError("segment_sum_sorted: rows must be [R, d]")
    n_seg, d = ptr.numel() - 1, rows.shape[1]
    out = torch.empty(n_seg, d, dtype=torch.float32, device=rows.device)
    if n_seg == 0 or d == 0:
        return out
    rc = build.lib("segment_sum").gsn_segment_sum_sorted(
        build.ptr(rows), build.ptr(ptr), build.ptr(perm), build.ptr(out),
        n_seg, d, build.stream_ptr(rows.device))
    build.check(rc, "segment_sum_sorted")
    segment_sum_sorted.launches += 1
    return out


segment_sum_sorted.launches = 0
