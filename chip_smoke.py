#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gsn_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure is an uncaught exception and a nonzero exit):

1. Print the card's name and power limit, turn TF32 off, build every
   CUDA kernel from ``gsn_tpu_torch/csrc`` (one ``nvcc`` per source, all
   at once, beside an empty kernel that measures the launch floor in
   phase 30) and print the build seconds.
2. Build the main path's batch: 1024 ZINC-like graphs with cycle counts
   k=3..8 (the port's copy of ``bench.py::make_zinc_like``), one batch at
   the tight epoch caps.
3. Hold each kernel (K1-K4) and both autograd Functions' backward passes
   against their plain PyTorch versions on the card at the main path's
   shapes (d=128), and time kernel, plain version and, where one exists,
   the one PyTorch call that computes the same function (device time;
   the kernel's host time to issue a call is reported beside it;
   ``time_ms`` refuses a window the host let go idle).  K4 copies rows,
   so it must equal its plain version bit for bit, here and at every
   other shape.  Then K4's stress shapes: empty graphs with trailing
   padding, leading padding, and one graph, at d in K4_STRESS_D, each
   with g aligned and as a view one float off 16-byte alignment, through
   K4, AddPool's backward and GraphBroadcast; and a ``[k4] ptxas`` line
   (registers, spills, blocks/SM of its three instantiations).  K4's
   rows also carry ``fill_ms``, a fill of the same output bytes.
4. Check the whole model on a small batch: the card (kernels) against the
   CPU (plain versions), same weights, forward and gradients.
5. Drive the main path: the ZINC GSN-EF model (``bench.py::zinc_cfg``:
   d=128, 4 layers, random weights from seed 0) takes STEPS Adam steps on
   the batch through ``Trainer.train_step``.  The launch counters are
   zeroed just before and read just after; each kernel must have run
   its expected number of times per step.  Prints the median step time
   and edges/s.
6. Profile PROFILE_STEPS more steps with ``torch.profiler`` (after the
   timed ones, so the timing runs without it): device busy time per
   step, the device's idle share of the unprofiled median step, the
   kernels that take the most device time, and each of the port's own
   kernels' device time per launch inside the step.  A profiler that records no
   device time prints "not measured" and does not fail the run.
7. Build the DGN batch: 1024 molhiv-like graphs with the edge-level
   cycle-count vector field (the port's copy of
   ``bench.py::make_dgn_like``), one batch at the tight caps; print its
   real node and edge counts.
8. Hold the DGN kernels K5/K6 in each instantiation (B5
   ``weighted_gather``, B6 ``segment_minmax``, B8 ``dgn_fused``) and
   their autograd Functions against the plain versions at the DGN
   shapes (d=70, K=5 weight columns from the batch's own vector field,
   node rows after relu so maxima tie; tie counts exact), and time each
   as in phase 3.  Then the same checks (forward, raw backward with and
   without dW, autograd) on stress shapes: a synthetic edge set with
   empty rows and a hub row of 100 edges, at d in {33, 64, 70, 130} and
   K in {1, 5, 16}.  A ``[dgn] ptxas`` line gives the registers, spills
   and resident blocks per SM of the path's K5/K6 instantiations, as
   ``nvcc -Xptxas -v`` and the occupancy calculator report them.  K4 as
   the DGN mean readout's backward (d=70) is checked and timed on a log
   line of its own.
9. Check a small DGN model (d=70, 2 layers, dropout 0) on the card
   against the CPU for one aggregator set per branch of the layer's
   kernel dispatch (fused, weighted only, minmax only); each branch must
   launch its kernels on the card.
10. Drive the DGN main path: ``bench.py::bench_dgn``'s configuration
    (d=70, 4 layers, 7 aggregators, dropout 0.3, BCE, Adam lr 1e-3)
    takes STEPS steps through ``Trainer.train_step``, launch counters
    zeroed just before and read just after, as in phase 5.
11. Drive the weighted-only and minmax-only paths at the same width and
    depth for BRANCH_STEPS steps each, counters zeroed before each.
12. Profile the DGN main path as phase 6 profiles the zinc one.
13. Build the molhiv batch: 1024 molhiv-like graphs (9 atom and 3 bond
    fields, induced edge-level cycle counts k=3..6 as ids; the port's
    copy of ``bench.py::make_molhiv_like``), one batch at the tight caps;
    print its real and slot node and edge counts.
14. Hold B4 (``graph_broadcast``: K4 forward, K3 backward) against its
    plain version at d=300, forward (bit for bit, padding rows 0) and
    through autograd, and K1/K2 in the ogb message's form (no A side, Pe
    given, relu, zero b1) against theirs; time B4 as phase 3 times K4,
    and K4 as the virtual node's sum-pool backward, K1/K2 in this form
    and B4's backward on log lines of their own.
15. Check a small ``GNN_OGB`` (d=32, 2 layers, virtual node, BN, dropout
    0) on the card against the CPU on a 60-graph batch in 64 graph slots;
    B4 and K1 must launch on the card.
16. Drive the molhiv main path: ``bench.py::molhiv_cfg`` (GSN-VN-AF:
    ``GNN_OGB``, ogb messages, local ids embedded to 300, d=300, hidden
    600, 5 layers, virtual node, dropout 0.5, mean readout, BCE, Adam lr
    1e-3) takes STEPS steps through ``Trainer.train_step``, launch
    counters zeroed just before and read just after (per step: K1 5, K2
    5, B4 5, K4 10, K3 15); prints the median step, real edges/s and peak
    memory.
17. Profile the molhiv main path as phase 6 profiles the zinc one.
18. The bf16 modes (``compute_dtype="bfloat16"``) at the zinc path's
    shapes (d=128): K1 (relu and identity), K2, K3 into bf16 (dB) and
    into f32 (the pool) and K4 on bf16 data, and the autograd
    Functions, against their plain versions: K4, dH, dPe and AddPool's
    backward bit for bit, K3 into f32 at the f32 tolerances, the rest at
    BF16_RTOL (one bf16 ulp: the plain versions sum in another order);
    each timed as in phase 3, with its bound from its bf16 bytes.
19. The same at the molhiv shapes (d=300): B4 (forward bit for bit,
    padding rows 0; backward K3 into bf16), K4 as the pool backward, and
    K1/K2 in the ogb form; B4's backward and the pool on log lines.
20. A small zinc model and a small ``GNN_OGB`` in bf16 on the card
    against the CPU from the same weights: loss rel 2e-2, all-parameter
    gradient cosine above 0.99 (``tests/test_compute_dtype.py:80-85``);
    K1 and K4 must launch in bf16 on the card and not on the CPU.
21. Drive the zinc path in bf16 (``zinc_cfg`` + ``compute_dtype=
    "bfloat16"``, d=128, 4 layers) for STEPS steps, counters zeroed just
    before and read just after: per step K1 4, K2 4, K3 9 (4 into bf16,
    5 into f32), K4 5, every one in bf16; the median step, real edges/s,
    peak memory and a profile as in phases 5-6.
22. The same for the molhiv path in bf16 (``molhiv_cfg`` +
    ``compute_dtype="bfloat16"``, d=300, 5 layers): per step K1 5, K2
    5, B4 5, K4 10, K3 15 (10 into bf16, 5 into f32).

23. K5/K6 on bf16 rows (``DGNConfig.compute_dtype="bfloat16"``) in
    each instantiation at the DGN shapes (d=70, K=5) against their plain
    versions: maxima and tie counts exact, dW at the f32 tolerances, the
    f32 weighted sums and the bf16 dh and dB at BF16_RTOL; forward, raw
    backward with and without dW, autograd; then phase 8's stress shapes
    on bf16 rows, a ``[dgn] ptxas bf16`` line, and each function timed
    with its bound from its bytes (B, g_w and dh in 2 bytes).  The
    autograd Functions' bf16 dB is held to K3's plain version of the
    kernel's own dh (checked itself at BF16_RTOL).
24. A small DGN model in bf16 for each dispatch branch, the card against
    the CPU at the bf16 gates; each branch's K5 must launch in bf16.
25. Drive the DGN path in bf16 (``bench_dgn``'s configuration +
    ``compute_dtype="bfloat16"``) for STEPS steps: per step K5 4 and K6
    4 in bf16, K3 6 (the f32 node sums and readout, 4 bf16 dB), K4 1
    (f32); the median step, real edges/s, peak memory and a profile;
    then BRANCH_STEPS steps each of the weighted-only and minmax-only
    paths in bf16.
26. K1/K2 in the fused-BN moments mode (``id_sq``) at d=128 on f32 and
    bf16 data, with A and Pe and without, and K3 from f32 rows into
    bf16, against their plain versions: the f32 moments and dH at the
    f32 tolerances, dA, dB and dPe in the data dtype (BF16_RTOL in
    bf16); timed with their bounds (the f32 mode, which no path runs,
    on ``[id_sq]`` log lines).
27. A small zinc model with ``bn_mlp=True`` in bf16, the card against
    the CPU: loss rel 2e-2, and a gradient cosine above the smaller of
    0.99 and the CPU's own bf16-against-f32 cosine on the same weights
    (training through the fused BN's batch statistics turns this
    model's gradient by more than 0.99 in bf16 itself); K1 and K2 must
    launch in id_sq mode.
28. Drive ``zinc_cfg`` + ``compute_dtype="bfloat16"`` + ``bn_mlp=True``
    for STEPS steps: per step K1 8 and K2 8 (4 relu and 4 id_sq, bf16),
    K3 13 (4 bf16 -> bf16, 4 f32 -> bf16, 5 bf16 -> f32), K4 5; the
    same numbers as phase 25.
29. The CLI's data: a synthetic ZINC set in the ZINC loader's layout
    (``write_zinc_dataset``: the ZINC subset's 10,000 / 1,000 / 1,000
    molecules, ``molecules/*.pickle``, ``indices/*.index``,
    ``10fold_idx/*_idx-0.txt``) in a temporary directory;
    ``prepare_dataset`` cold and from its cache (both times, the id
    vocabulary).
30. The CLI path (zinc-cli): ``gsn_tpu_torch.cli.main`` with
    ``scripts/zinc_10_runs.py``'s flags at the 500K budget (d=150, 4
    layers, batch 128, Plateau, L1), 2 epochs with an evaluation each,
    on the card, launch counters zeroed just before and read just after:
    exactly K3 13 (f32->f32) and K4 5 a train step and K3 5 an eval step
    (``bn_mlp`` is on, so f32 messages take the per-edge path: each
    layer's messages are summed at their receivers by K3, backward K4,
    the backward of its two gathers, ``A[recv]`` and ``B[send]``, is K3
    over the receivers and over the senders, and the one pool is K3,
    backward K4); finite
    histories, the lr at each evaluation, ``log.jsonl``, ``params.json``
    and the checkpoint, each epoch's seconds, median step and host
    batching ms a step, peak memory, the ``watch`` count.  Then 1 epoch
    with ``--compute_dtype bfloat16`` (zinc-cli-bf16: K1/K2 4 bf16 + 4
    bf16 id_sq, K3 9, K4 1 a train step; K1 4, K3 1 an eval step); both
    runs go through the trainer's one-dispatch epochs (``scan_epochs``,
    the CLI's default: a CUDA graph of each train and eval step,
    replayed), and the counters count each replay's launches; K1/K2
    (f32 and bf16, relu and id_sq; the f32 rows'
    launches are phase 41's ep run's), K3 (the
    messages' sum, the pools beside ``index_add`` and
    ``segment_reduce``, dB) and K4 at d=150 on one train batch against
    their plain versions, timed with bounds; K3's launches by form are
    asserted too (a train step: warp 12 and block 1, the pool; bf16:
    warp 8, block 1; an eval step: warp 4 and block 1, or block 1 in bf16),
    the pool f32 and each K3 row carry the form ``segment_sum_form``
    picked and the launch floor of its own grid (``floor_ms``, an empty
    kernel on ``blocks`` blocks; K1's and K2's rows on their grid; K2's
    rows also time the wrapper's zero fill of dH (every slot) alone,
    ``pad_fill_ms``), and the block form called twice on the pool's rows
    gives the same bits; the launch floor on the zinc path's pool grids
    goes on log lines.
31. ``--mode test`` on phase 30's checkpoint gives its last test metric
    (rtol 1e-5); ``--resume True --num_epochs 3`` trains epoch 2 only;
    phase 30's two epochs' train losses equal an uninterrupted 3-epoch
    run's first two, and the resumed epoch's train loss equals its
    third, bit for bit (every sum on the path has a fixed order).
32. ``--mode isomorphism_test`` on SR(16,6,2,2) (the 4x4 rook's graph
    and the Shrikhande graph, ``write_sr16622``) on the card: GSN with
    edge-level K3/K4 counts fails 0% of the pairs, the MPNN 100%.
33. K1, K2 and K3 against their plain versions across widths
    (SWEEP_D: 1, 2, 6, 37, 75, 150, 298, 689) on f32 and bf16: K3 in
    both forms, with and without ``perm``, into f32 and bf16, over
    segments of
    SWEEP_LENGTHS (empty ones, 1 to 2,000 rows) and 300 of 0-4 rows,
    starting 13 rows in; each call repeated must give the same bits; K1
    and K2 in every mode (relu, identity, id_sq; with and without A and
    Pe) with the same segments as receivers: K2's relu and identity dH
    bit for bit, its id_sq dH at the f32 tolerances, and a repeated K2
    call with the same bits.  Sums of the same terms in another order
    (K1, K2's dA, K3): bf16 within one ulp, f32 within the f32
    tolerances plus the worst-case rounding of two f32 sums of the row's
    terms (the long rows cancel).
34. Repeatable receiver sums: ``zinc_cfg`` with ``aggr="mean"`` (per
    step K3 17: the 4 receiver means, the 8 gathers' backward and the 5
    pools; K4 9) and
    ``bench_dgn`` with ``var`` and ``std`` added (K3 and K4 each 4 more a
    step than phase 10: two receiver means each) take C3_STEPS steps
    twice from seed 0; the losses must be equal bit for bit, and a
    profiled step must run no ``index_add``.
35. B1's ``num_send_nodes`` mode: phase 2's batch split by
    ``parallel.make_ep_batch`` into SPLIT_D shards; in each of
    SPLIT_MODES (f32 relu, bf16 relu, f32 id_sq) each shard's K1, K2 and
    K3 (dB into all the batch's sender rows) against their plain
    versions, with A, g and the output over the shard's block of rows
    and B over all of them; the shards' stacked K1 outputs equal the
    unpartitioned K1's bit for bit.  Shard 0's calls are timed with
    their bounds (the block's receivers with edges, the senders the
    shard touches, its edges) and launch floors, beside K1 on the same
    edges with the shard's senders compacted into B's first rows
    (``compact_ms``; the same bits).  Rows ``kernel[num_send ...]``.
36. ``parallel.ParallelTrainer`` on NCCL at world size 1, dp and ep,
    STEPS steps each of ``zinc_cfg`` on phase 2's batch (its one dp
    shard, its one ep shard): launches a step as phase 5's, the loss
    falls, the losses against phase 5's (f32 tolerances; whether bit for
    bit is logged), the median step and a profile as in phases 5-6; the
    host time of one collective call, and a step of one device, dp and
    ep in turns (TURNS rounds).
    Then C3_STEPS steps of the ep path in bf16 and with ``bn_mlp`` (f32
    id_sq under ep), launches by mode asserted; these runs give phase
    35's rows their launches.
37. ``cli.main`` with ``--parallel dp`` and ``--parallel ep``
    ``--parallel_devices 1`` (one spawned NCCL rank) for one epoch of
    phase 30's data and flags: a finite history, and the first epoch's
    train loss within CLI_PARALLEL_RTOL of phase 30's.
38. The gin path's data and kernels: ``write_imdb_dataset`` writes
    IMDB_GRAPHS IMDB-BINARY-like ego-networks (one node tag, ten folds)
    in the TU layout; ``cli.prepare`` counts them (``complete_graph``
    k=5, local, non-induced; the host seconds cold and from the cache
    are logged) and encodes them.  On one train batch of IMDB_BATCH
    graphs, K1 and K2 in the gin message's identity form (no A side, a
    zero b1; a node part with B the rows, an edge part with a zero B and
    Pe the rows) at the layer-0 widths (x: 1; the one-hot ids with their
    central column) and IMDB_D, against their plain versions (K1 at the
    f32 tolerances, K2's dH bit for bit), timed beside one PyTorch call
    of the same function (``torch.sparse.mm`` of the CSR receiver
    adjacency with B, ``index_add`` of Pe, ``index_select`` of g), with
    bounds and the launch floor of K1's grid.  The forms the path runs
    are rows ``edge_message_fwd[gin ...]`` / ``edge_message_bwd_recv[gin
    ...]``; the others go on log lines.
39. README.md's IMDBBINARY command (``--model_name GSN_sparse --msg_kind
    gin``) through ``cli.main``, fold 0, 2 epochs of 50 steps: a small
    gin model on the card against the CPU first; then a finite history,
    launches exactly (a train step: K1 5 = layer 0's node and edge
    parts and one part a later layer, K2 3, K3 8 = 3 dB and 5 pools, K4
    4; an eval step: K1 5, K3 5; K1/K2 also by row width), each epoch's
    seconds, median step and host-batching share; STEPS steps on one
    batch (median, edges/s), a profiled step (busy, idle share) and one
    ``train/profiling.py::step_stats`` line.
40. The directional CLI: ``write_molhiv_dataset`` writes DGN_CLI_GRAPHS
    molhiv-like molecules as OGB raw files with an 80/10/10 split, and
    ``cli_directional.main`` runs scripts/dgn_molhiv_10_runs.py's flags
    (hidden 60, 4 layers, the seven aggregators, cycle_graph k=6 local
    directions, dropout 0.3) for 2 epochs: a finite best-val tuple,
    launches exactly (a train step: K5/K6 fused 4 each, K3 6, K4 1; an
    eval step: K5 4, K3 2), each epoch's seconds; K5/K6 ``<fused>`` at
    the path's d=60 against their plain versions and timed (rows
    ``dgn_fused_fwd[d=60 K=...]``), STEPS steps and a profiled step on
    one batch; then ``--parallel dp --parallel_devices 1`` (one spawned
    NCCL rank) for one epoch: its train loss within CLI_PARALLEL_RTOL of
    the serial run's first epoch (bit for bit logged).
41. The multi-process CLI: ``cli.main`` with phase 30's data and flags
    and ``--coordinator_address 127.0.0.1:<free port>
    --num_procs_distributed 1 --process_id 0`` (this process joins an
    NCCL group of one through ``parallel.distributed.initialize``; its
    epochs graphed, as a spawned rank's) for one epoch, first without ``--parallel`` (the dp default, whose line
    must be printed), then with ``--parallel ep``: launches a train and
    an eval step exactly (``cli_path``): dp phase 30's; ep those of the
    fused-BN route that f32 ``bn_mlp`` messages take under ep, as in the
    reference (a train step K1/K2 f32 4 and f32 id_sq 4 each, K3 9, K4
    1; an eval step K1 4, K3 1; they are the launches of phase 30's f32
    K1/K2 rows at d=150); a finite history,
    the first epoch's train loss within CLI_PARALLEL_RTOL of phase 30's
    (bit for bit logged), one log, one checkpoint, and no process group
    left when ``cli.main`` returns.  Then ``python -m gsn_tpu_torch.cli``
    with the same flags in a process of its own (600 s timeout): exit 0
    and the in-process dp run's first-epoch train loss bit for bit.
42. The edge-partitioned propagates at ``scaling_efficiency_bench``'s
    defaults (EP_NODES nodes, degree EP_DEGREE, d=EP_D; message
    ``tanh(x_i) + 2·x_j``) over an NCCL group of one formed by
    ``distributed.initialize``: the all-gather and the ring propagate,
    forward and gradient against the plain CPU version (one device,
    ``index_add``) at the f32 tolerances, launches exactly K3 2 and K4 2
    (one receiver sum a propagate, and its backward), and
    ``scaling_efficiency_bench``'s two rates on a log line.  K3 on the propagate's CSR-ordered messages and K4 on
    its backward's shapes against their plain versions, timed beside
    ``index_add`` and ``segment_reduce`` (K3) and ``index_select`` (K4),
    with bytes bounds: rows ``segment_sum_sorted[propagate d=128]`` and
    ``segment_broadcast[propagate d=128]``.
43. The one-dispatch epochs (``TrainerConfig.scan_epochs``: each run of
    same-shape batches replays a CUDA graph of the whole train step,
    K1-K6 inside, and of the eval step).  Four paths each run from one
    seed and weights with graphs, per step, and with graphs again:
    zinc-cli f32 (2 epochs, each evaluated on train, test and val),
    zinc-cli-bf16 (1 epoch), molhiv GSN-VN-AF (``molhiv_cfg``, 2 epochs
    of ``make_molhiv_like(1024)`` at batch MOLHIV_BATCH, ROC-AUC) and
    dgn-cli (2 epochs of phase 40's data and flags).  The two graphed
    runs must agree bit for bit, and so must the graphed and the
    per-step run (train losses, evaluations, every parameter and BN
    statistic) on the zinc paths; on the dropout paths (molhiv,
    dgn-cli) whether they do is logged, and they are held to the f32
    tolerances.  Each path logs its capture seconds, the graph's device
    time a step (CUDA events about each replay) beside the per-step
    epochs' median step, the peak memory of the graphed run (its graphs'
    pools included) and EPOCH_TURNS rounds of a graphed and a per-step
    epoch in turns.  zinc-cli's cached graphed epoch and an evaluation
    run under ``torch.cuda.set_sync_debug_mode`` (at most one blocking
    read in the epoch's one run and in the split), and a per-step and a
    graphed epoch run under the profiler (device busy and idle share).
44. Graphed parallel epochs: ``ParallelTrainer`` on an NCCL group of one
    in this process (``distributed.initialize``) graphs each run of
    same-shape dp or ep batches, its collectives (the loss's and the BN
    moments' all-reduces, the ep all-gathers and reduce-scatters, the
    gradient sum, the evaluation's sums and ROC-AUC rows) captured with
    the step.  Three paths each run PARALLEL_EPOCHS epoch(s) from one
    seed graphed, per step and graphed again, each epoch evaluated:
    zinc-cli-dp and zinc-cli-ep (phase 30's data and flags under
    ``--parallel dp`` / ``ep``'s trainer) and dgn-cli-dp (phase 40's
    under ``--parallel dp``'s).  The two graphed runs must agree bit for
    bit, and so must the graphed and the per-step run on the zinc paths
    (dgn-cli-dp, whose dropout masks come from a registered generator,
    is logged and held to the f32 tolerances if not).  Each then runs
    EPOCH_TURNS rounds of a graphed and a per-step epoch in turns; in
    the first round each epoch's counters are zeroed just before it and
    read just after: a cached graphed epoch launches exactly what a
    per-step epoch does, by kernel and mode, and that is a train step's
    launches of the path (phase 30's under dp, phase 41's under ep,
    phase 40's) times the steps.  Each logs its capture seconds, a
    replay's device time, the peak memory, the epochs in turns, the
    blocking reads of a cached graphed epoch and of an evaluation under
    ``set_sync_debug_mode`` (at most one in the epoch's one run and in
    the split's), and a profiled graphed epoch (device busy and idle
    share).

Then it prints three lines: ``{"kernels": [...]}`` (each kernel's
checks, times, bound and its launches on the path named in its
``path``; a bf16 mode's row is named ``kernel[bf16 ...]``, a fused-BN
moments mode's ``kernel[id_sq ...]``, the split sender space's
``kernel[num_send ...]``), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
Without a CUDA card, or outside the repository, it exits nonzero before
printing any of them.
"""

import copy
import dataclasses
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

STEPS = 20
PROFILE_STEPS = 5
# phases 34 and 36: the steps of each repeat run and of the extra ep runs
C3_STEPS = 3
# phase 36: rounds of steps in turns (one device, dp, ep)
TURNS = 12
# phase 35: the shards of the main path's batch, and the modes
SPLIT_D = 4
SPLIT_MODES = (("f32", "relu"), ("bf16", "relu"), ("f32", "id_sq"))
# phase 37: the first epoch's train loss (an evaluation after Adam steps
# that move the biases ahead of each BN by noise) against the serial
# run's
CLI_PARALLEL_RTOL = 2e-2
D = 128
# the CLI path: the ZINC subset's split sizes (train, val, test) and
# scripts/zinc_10_runs.py's width and depth at the 500K budget
ZINC_SIZES = (10000, 1000, 1000)
CLI_D = 150
ZINC_CLI_LAYERS = 4
# bench.py::bench_dgn: width, aggregators (K=5 of them are weighted sums)
DGN_D = 70
DGN_AGGS = ("mean", "max", "min", "dir0-av", "dir1-av", "dir2-av",
            "dir3-av")
DGN_K = 5
# bench.py::molhiv_cfg: width (hidden 2x)
MOLHIV_D = 300
# one aggregator set per branch of the DGN layer's kernel dispatch
DGN_BRANCHES = {
    "fused": DGN_AGGS,
    "weighted": ("mean", "dir0-av", "dir1-av", "dir2-av", "dir3-av"),
    "minmax": ("max", "min"),
}
BRANCH_STEPS = 3
# timing windows time_ms tries before it fails (each holds at least
# twice as long as the last held and took to issue)
HOLD_TRIES = 5
# K4's stress widths: below a float4, odd, the paths' 70, 128 and 300,
# and 130 (rows that are not whole float4s past 128)
K4_STRESS_D = (1, 3, 33, 70, 128, 130, 300)
# phase 33's widths for K1-K3 (one element: the gin path's layer-0 x,
# one pair of elements, three pairs, odd, 75 pairs, zinc-cli's 150, two
# column tiles of pairs, and the gin path's odd id width) and segment
# lengths (empty ones, chunk edges at 31-33 and 64, long ones to 2,000)
SWEEP_D = (1, 2, 6, 37, 75, 150, 298, 689)
SWEEP_LENGTHS = (0, 1, 2, 3, 4, 5, 0, 7, 8, 9, 16, 31, 32, 33, 0, 64, 100,
                 257, 1000, 2000)
# f32 tolerances (tests/test_mxu_integration.py:48,79-84)
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
GRAD_RTOL = 2e-3
# bf16 kernel outputs that a plain version sums in another order: one
# bf16 ulp (2^-7 relative at most) / atol 1e-4 * max|want|
BF16_RTOL = 8e-3
# bf16 models card vs CPU (tests/test_compute_dtype.py:80-85): loss rel
# 2e-2, all-parameter gradient cosine > 0.99
BF16_LOSS_REL, BF16_COSINE = 2e-2, 0.99
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def spin_cycles_per_ms():
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    cycles = 10 ** 7
    start, end = _events()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(fn, cycles_per_ms, iters=50, warmup=3, guard=True):
    """(device ms, host ms) per call of ``fn`` over ``iters`` back-to-back
    calls.  A spin kernel holds the stream until every call is queued, so
    the CUDA events see the device time alone, not the host's cost of
    issuing each call through its Python wrapper; that cost is the host
    ms.  With ``guard``, a window whose hold had ended (its start event
    had fired) before the host finished issuing it may have let the
    device idle inside it: it is refused and retried with a hold twice
    as long and at least twice that issue time, up to HOLD_TRIES
    windows, and then the run fails.  The check reads the event, not
    the clock, as the spin's length in ms follows the card's clock.  A
    ``fn`` that synchronises (the plain versions read data-dependent
    sizes back) pays its host time in the device time and is timed with
    ``guard=False``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    hold_ms = min(2e3 * (time.perf_counter() - t0), 500.0)
    issues = []
    for _ in range(HOLD_TRIES):
        start, end = _events()
        t_hold = time.perf_counter()
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        end.record()
        issue_ms = (time.perf_counter() - t_hold) * 1e3
        held = not start.query()
        torch.cuda.synchronize()
        if not guard or held:
            return start.elapsed_time(end) / iters, host_ms
        issues.append((hold_ms, issue_ms))
        log(f"[time_ms] window refused: the hold of {hold_ms:.3f} ms ended "
            f"before the host had issued the window ({issue_ms:.3f} ms)")
        hold_ms = 2 * max(hold_ms, issue_ms)
    raise AssertionError(
        f"time_ms: every window's hold ended before its issue did (hold "
        f"ms, issue ms): {issues}")


def bound(nbytes, nops):
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, rtol, atol, what):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs err {err})")
    return err


def grad_check(got, want, what):
    atol = 1e-4 * max(float(w.abs().max()) for w in want)
    return max(max_err(g, w, GRAD_RTOL, atol, f"{what} d{i}")
               for i, (g, w) in enumerate(zip(got, want)))


def exact(got, want, what):
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version")


def bf16_check(got, want, what):
    """A bf16 kernel output against its plain version's, at BF16_RTOL /
    atol 1e-4 * max|want|; both must be bf16."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{what}: dtypes {got.dtype}, {want.dtype}")
    return max_err(got, want, BF16_RTOL,
                   1e-4 * float(want.float().abs().max()), what)


def fn_grads(fn, leaves, cots):
    """Gradients of sum(out * cot) over ``fn``'s outputs w.r.t. fresh
    copies of ``leaves``."""
    leaves = [x.clone().requires_grad_(True) for x in leaves]
    outs = fn(*leaves)
    return torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cots)), leaves)


def k4_layouts():
    """K4's stress layouts: name -> (segment offsets [G+1], rows)."""
    sizes = np.random.RandomState(5).randint(1, 40, 300)
    sizes[::7] = 0
    off = np.cumsum(sizes)
    return {
        "empty graphs, trailing padding": (np.r_[0, off], off[-1] + 37),
        "leading padding": (np.r_[13, 13 + off], off[-1] + 13),
        "G=1": (np.array([3, 900]), 950),
    }


def k4_stress(dev):
    """Phase 3's K4 stress shapes (see module docstring); returns the
    number of cases, each equal to its plain version bit for bit."""
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_pool as k4

    cases = 0
    for name, (ptr, n_rows) in k4_layouts().items():
        ptr = torch.from_numpy(ptr.astype(np.int32)).to(dev)
        G = ptr.numel() - 1
        for d in K4_STRESS_D:
            gen = torch.Generator(device=dev).manual_seed(d)
            base = torch.randn(G * d + 1, device=dev, generator=gen)
            x = torch.randn(n_rows, d, device=dev, generator=gen)
            # the view one float into base is not 16-byte aligned
            for where, sl in (("aligned", slice(0, G * d)),
                              ("unaligned view", slice(1, G * d + 1))):
                tag = f"K4 {name} d={d} {where}"
                g = base[sl].view(G, d)
                want = k4.segment_broadcast_plain(g, ptr, n_rows)
                exact(k4.segment_broadcast(g, ptr, n_rows), want, tag)
                # AddPool's backward is K4 of the cotangent g as given
                xl = x.clone().requires_grad_(True)
                (dx,) = torch.autograd.grad(k4.add_pool(xl, ptr), [xl],
                                            grad_outputs=g)
                exact(dx, want, f"{tag} AddPool backward")
                bl = base.clone().requires_grad_(True)
                out = k4.graph_broadcast(bl[sl].view(G, d), ptr, n_rows)
                exact(out, k4.graph_broadcast_plain(g, ptr, n_rows),
                      f"{tag} GraphBroadcast")
                (dv,) = torch.autograd.grad((out * x).sum(), [bl])
                grad_check([dv[sl].view(G, d)],
                           [k3.segment_sum_sorted_plain(x, ptr)],
                           f"{tag} GraphBroadcast backward")
                cases += 1
    torch.cuda.synchronize()
    return cases


def k4_timed(timed, data, g, kernel, plain):
    """K4 (``kernel`` is ``segment_broadcast`` or B4's
    ``graph_broadcast``) at a path's shape: ``g`` [G, d] over the batch's
    graphs into its node slots, through ``k4_timed_ptr``."""
    return k4_timed_ptr(timed, g, data.graph_ptr, data.num_node_slots,
                        kernel, plain)


def k4_timed_ptr(timed, g, ptr, n_rows, kernel, plain):
    """K4 of ``g`` [G, d] over the segments ``ptr`` into ``n_rows`` rows,
    equal to ``plain`` bit for bit and to one ``index_select`` over ``g``
    with a zero row appended; timed beside both, with its bytes bound
    (segments with rows read, every row written, in g's dtype) and, as
    ``fill_ms``, a fill of an output-sized tensor: the streaming write K4
    is to approach."""
    G, d = g.shape
    want = plain(g, ptr, n_rows)
    exact(kernel(g, ptr, n_rows), want, f"{kernel.__name__} d={d}")
    g_ext = torch.cat([g, torch.zeros(1, d, dtype=g.dtype, device=g.device)])
    seg_of = torch.full((n_rows,), G, dtype=torch.long, device=g.device)
    seg_of[int(ptr[0]):int(ptr[-1])] = torch.repeat_interleave(
        torch.arange(G, device=g.device), ptr.diff().long())
    exact(torch.index_select(g_ext, 0, seg_of), want,
          f"library {kernel.__name__} d={d}")
    t_b, by = bound(g.element_size() * (int((ptr.diff() > 0).sum()) + n_rows)
                    * d + 4 * (G + 1), 0)
    return dict(max_abs_err=0.0, bound_ms=t_b, bound_by=by,
                **timed(lambda: kernel(g, ptr, n_rows),
                        lambda: plain(g, ptr, n_rows),
                        lambda: torch.index_select(g_ext, 0, seg_of),
                        fill=want.zero_))


def log_row(tag, name, row):
    log(f"[{tag}] {name} " + " ".join(f"{k} {v}" for k, v in row.items()))


def dgn_stress_segments(dev):
    """The DGN stress shapes' edge set: 1200 edges over 400 receivers,
    some rows empty and one a hub of 100 edges; (segments, rows)."""
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    rng = np.random.RandomState(4)
    n, e, hub = 400, 1200, 100
    recv = rng.randint(0, n, e)
    recv[:hub] = n // 2
    recv = np.sort(recv)
    send = rng.randint(0, n, e).astype(np.int32)
    ptrs = [np.zeros(n + 1, np.int32) for _ in range(2)]
    for ptr, keys in zip(ptrs, (recv, send)):
        np.cumsum(np.bincount(keys, minlength=n), out=ptr[1:])
    perm = np.argsort(send, kind="stable").astype(np.int32)
    seg = k12.EdgeSegments(*(torch.from_numpy(a).to(dev)
                             for a in (ptrs[0], send, ptrs[1], perm)))
    deg = seg.recv_ptr.diff()
    if not (deg == 0).any() or int(deg.max()) < hub:
        raise AssertionError("stress edge set lacks empty or hub rows")
    return seg, n


def dgn_stress(dev):
    """Phase 8's stress shapes (see module docstring); returns the number
    of (width, K) cases checked."""
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    from gsn_tpu_torch.ops.cuda import slab_weighted as b58

    seg, n = dgn_stress_segments(dev)
    e = seg.send.numel()
    rp, send = seg.recv_ptr, seg.send

    def dB_plain(dh):
        return k3.segment_sum_sorted_plain(dh, seg.send_ptr, seg.send_perm)

    cases = 0
    for d in (33, 64, 70, 130):
        gen = torch.Generator(device=dev).manual_seed(d)
        B = torch.relu(torch.randint(-3, 4, (n, d), device=dev,
                                     generator=gen).float()) * 0.5
        g_mm = torch.randn(n, 2 * d, device=dev, generator=gen)
        tag = f"stress d={d}"
        mm_p, cnt_p = b6.segment_minmax_fwd_plain(B, rp, send)
        mm, cnt = b6.segment_minmax_fwd(B, rp, send)
        max_err(mm, mm_p, FWD_RTOL, FWD_ATOL, f"{tag} segment_minmax_fwd")
        exact(cnt, cnt_p, f"{tag} segment_minmax_fwd tie counts")
        dh_mm = b6.minmax_dh_plain(B, mm_p, cnt_p, g_mm, rp, send)
        grad_check([b6.segment_minmax_bwd(B, mm, cnt, g_mm, rp, send)],
                   [dh_mm], f"{tag} segment_minmax_bwd")
        grad_check(fn_grads(lambda b: (b6.segment_minmax(b, seg),), [B],
                            [g_mm]), [dB_plain(dh_mm)],
                   f"{tag} SegmentMinmax")
        for K in (1, 5, 16):
            tag = f"stress d={d} K={K}"
            W = torch.rand(e, K, device=dev, generator=gen)
            g_w = torch.randn(n, K * d, device=dev, generator=gen)
            out_p = b58.weighted_gather_fwd_plain(B, W, rp, send)
            max_err(b58.weighted_gather_fwd(B, W, rp, send), out_p,
                    FWD_RTOL, FWD_ATOL, f"{tag} weighted_gather_fwd")
            out, mm, cnt = b58.dgn_fused_fwd(B, W, rp, send)
            max_err(out, out_p, FWD_RTOL, FWD_ATOL, f"{tag} dgn_fused_fwd")
            max_err(mm, mm_p, FWD_RTOL, FWD_ATOL, f"{tag} dgn_fused_fwd mm")
            exact(cnt, cnt_p, f"{tag} dgn_fused_fwd tie counts")
            for need_dw in (False, True):
                n_out = 1 + need_dw
                grad_check(
                    b58.weighted_gather_bwd(B, W, g_w, rp, send,
                                            need_dw)[:n_out],
                    b58.weighted_gather_bwd_plain(B, W, g_w, rp, send,
                                                  need_dw)[:n_out],
                    f"{tag} weighted_gather_bwd[dW={need_dw}]")
                grad_check(
                    b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, rp, send,
                                      need_dw)[:n_out],
                    b58.dgn_fused_bwd_plain(B, W, g_w, mm_p, cnt_p, g_mm,
                                            rp, send, need_dw)[:n_out],
                    f"{tag} dgn_fused_bwd[dW={need_dw}]")
            dh_w, dW_p = b58.weighted_gather_bwd_plain(B, W, g_w, rp, send,
                                                       True)
            grad_check(fn_grads(lambda b, w: (b58.weighted_gather(b, w, seg),),
                                [B, W], [g_w]), [dB_plain(dh_w), dW_p],
                       f"{tag} WeightedGather")
            grad_check(fn_grads(lambda b, w: b58.dgn_fused(b, w, seg), [B, W],
                                [g_w, g_mm]),
                       [dB_plain(dh_w + dh_mm), dW_p], f"{tag} DGNFused")
            cases += 1
    torch.cuda.synchronize()
    return cases


def ptxas_report(source, key):
    """{key: {"regs", "smem", "spill"}} from what ``nvcc -Xptxas -v``
    reported when this process built ``csrc/<source>.cu``, for each entry
    function whose mangled name ``key`` maps to a key (not None)."""
    from gsn_tpu_torch.ops.cuda import build
    fns, cur = {}, None
    for line in build.build_logs.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = key(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            fns.setdefault(cur, {})["spill"] = int(m.group(1)) + int(
                m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            fns.setdefault(cur, {}).update(
                regs=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
    return fns


def k4_ptxas_line():
    """The ``[k4] ptxas`` line: registers, static shared memory and spill
    bytes of K4's instantiations (f32 words with loads of g of 4, 2 or 1
    floats; bf16 words with loads of 8, 4, 2 or 1), and the resident
    blocks per SM of each at the widths that take it (its row table in
    shared memory grows as the width shrinks)."""
    from gsn_tpu_torch.ops.cuda import build

    def key(name):
        # <element bytes (4: f32, 2: bf16), elements a load>
        m = re.search(r"segment_broadcast_kernelILi(\d)ELi(\d)E", name)
        return (int(m.group(1)), int(m.group(2))) if m else None

    fns = ptxas_report("segment_broadcast", key)
    if not fns:
        return ("[k4] ptxas: not reported (the library was not built in "
                "this process)")
    lib = build.lib("segment_broadcast")
    parts = []
    for es, occ, loads in (
            (4, lib.gsn_segment_broadcast_occupancy,
             ((4, (D, MOLHIV_D)), (2, (DGN_D,)), (1, (33, 1)))),
            (2, lib.gsn_segment_broadcast_occupancy_bf16,
             ((8, (D,)), (4, (MOLHIV_D,)), (2, (DGN_D,)), (1, (33, 1))))):
        dtype = "f32" if es == 4 else "bf16"
        for load, widths in loads:
            info = fns.get((es, load), {})
            parts.append(
                f"<{dtype}, {load}-element loads> {info.get('regs')} regs "
                f"{info.get('smem')} B smem {info.get('spill')} B spilled, "
                "blocks/SM " + ", ".join(f"{occ(d, load)} at d={d}"
                                         for d in widths))
    return "[k4] ptxas: " + "; ".join(parts)


def dgn_ptxas_line(d, K, dtype="f32"):
    """The ``[dgn] ptxas`` line: registers, shared memory and spill bytes
    that ``nvcc -Xptxas -v`` reported for the K5/K6 instantiations over
    rows of ``dtype`` (f32 or bf16) that the DGN paths launch at width d
    with K weight columns (and for the dW form of K6), with each one's
    resident blocks per SM, and the most registers and spill bytes over
    every instantiation of that element type."""
    from gsn_tpu_torch.ops.cuda import build

    def key(name):
        # <V, NG, KT, WEIGHTED, MINMAX[, DW], T> from the mangled name
        a = re.search(r"dgn_aggregate_(fwd|bwd)_kernelI((?:L[ib]\d+E)+)"
                      r"(\w)", name)
        return ((a.group(1),) + tuple(
            int(x) for x in re.findall(r"L[ib](\d+)E", a.group(2)))
                + ("f32" if a.group(3) == "f" else "bf16",)
                if a else None)

    fns = {k: v for k, v in ptxas_report("dgn_aggregate", key).items()
           if k[-1] == dtype}
    if not fns:
        return (f"[dgn] ptxas {dtype}: not reported (the library was not "
                "built in this process)")
    lib = build.lib("dgn_aggregate")
    if dtype == "f32":
        vec = 4 if d % 4 == 0 else 1
        v, ng = (4, 1) if vec == 4 else (1, 3)
        occupancy = lib.gsn_dgn_aggregate_occupancy
    else:   # one layout
        vec, (v, ng) = None, (1, 3)
        occupancy = lib.gsn_dgn_aggregate_occupancy_bf16
    kt = 5 if K == 5 else 0
    parts = []
    for name, w, mmx, dw in (("fused", 1, 1, 0), ("fused+dW", 1, 1, 1),
                             ("weighted", 1, 0, 0), ("minmax", 0, 1, 0)):
        for bwd, kname in ((0, "K5"), (1, "K6")):
            if dw and not bwd:
                continue
            key = (("bwd", v, ng, kt if w else 0, w, mmx, dw, dtype) if bwd
                   else ("fwd", v, ng, kt if w else 0, w, mmx, dtype))
            info = fns.get(key, {})
            blocks = occupancy(bwd, d, K, w, mmx, dw,
                               *(() if vec is None else (vec,)))
            parts.append(f"{kname}<{name}> {info.get('regs')} regs "
                         f"{info.get('smem')} B smem {info.get('spill')} B "
                         f"spilled {blocks} blocks/SM")
    most = max(f.get("regs", 0) for f in fns.values())
    spill = sum(f.get("spill", 0) for f in fns.values())
    return (f"[dgn] ptxas {dtype} at d={d} K={K} (layout V={v} NG={ng}): "
            + "; ".join(parts) + f"; all {len(fns)} {dtype} "
            f"instantiations: at most {most} regs, {spill} B spilled in all")


def train_steps(trainer, state, data, steps, counters):
    """``steps`` Adam steps; the launch counters are zeroed just before
    and read just after.  Returns (state, losses, step seconds,
    launches by name, launches by name and mode)."""
    from gsn_tpu_torch.ops.cuda import build
    for fn in counters.values():
        build.reset(fn)
    torch.cuda.synchronize()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, data)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {name: fn.launches for name, fn in counters.items()}
    modes = {name: dict(fn.modes) for name, fn in counters.items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    return state, losses, step_s, launches, modes


def expect_launches(launches, per_step, steps, what, modes=None,
                    per_step_modes=None):
    """Every counter must show exactly its launches a step (0 for the
    kernels the path does not run) and, where ``per_step_modes`` names a
    kernel, exactly those launches a step in each mode."""
    for name, n in launches.items():
        want = per_step.get(name, 0) * steps
        if n != want:
            raise AssertionError(f"{what}: {name} launched {n} times in "
                                 f"{steps} steps, expected {want}")
    for name, by_mode in (per_step_modes or {}).items():
        want = {m: k * steps for m, k in by_mode.items()}
        if modes[name] != want:
            raise AssertionError(f"{what}: {name} launched {modes[name]} "
                                 f"by mode in {steps} steps, expected "
                                 f"{want}")


def device_events(prof):
    """(device us, event) of each kernel, copy and fill a profile
    recorded: CPU ops also carry the device time of what they launched,
    and user annotations (Optimizer.step) span kernels already counted."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    events = [(dev_us(e), e) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return [(us, e) for us, e in events if us > 0]


def profile_steps(trainer, state, data, step_ms, tag):
    """Phases 6, 12 and 17 (see module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    # only the profiler's own start and stop may be refused; a failure in
    # the steps themselves propagates and fails the run
    prof = profile(activities=acts)
    try:
        prof.start()
    except RuntimeError as exc:
        log(f"[profile {tag}] not measured ({exc})")
        return
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        state, _ = trainer.train_step(state, data)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / PROFILE_STEPS
    try:
        prof.stop()
    except RuntimeError as exc:
        log(f"[profile {tag}] not measured ({exc})")
        return
    events = device_events(prof)
    if not events:
        log(f"[profile {tag}] not measured (no device time recorded)")
        return
    busy = sum(us for us, _ in events) / PROFILE_STEPS
    n_kernels = sum(e.count for _, e in events) / PROFILE_STEPS
    log(f"[profile {tag}] per step: device busy {busy / 1e3:.3f} ms in "
        f"{n_kernels:.0f} launches; profiled wall {wall * 1e3:.3f} ms; "
        f"device idle share {1 - busy / 1e3 / step_ms:.3f} of the "
        f"unprofiled median step ({step_ms:.3f} ms)")
    events.sort(key=lambda ue: -ue[0])
    for us, e in events[:12]:
        log(f"[profile {tag}]   {us / PROFILE_STEPS:9.1f} us/step  "
            f"x{e.count / PROFILE_STEPS:5.1f}  {e.key[:90]}")
    # the port's own kernels (namespace gsn) inside the step
    ours = [(us, e) for us, e in events if "gsn::" in e.key]
    share = sum(us for us, _ in ours) / PROFILE_STEPS / busy
    log(f"[profile {tag}] the port's kernels: {share:.4f} of device busy time")
    for us, e in ours:
        log(f"[profile {tag}]   {us / e.count:9.2f} us/launch  "
            f"x{e.count / PROFILE_STEPS:5.1f}/step  {e.key[:90]}")


def one_batch(graphs, dev):
    """All ``graphs`` as one batch at the tight epoch caps: (the batch on
    the host, on ``dev``)."""
    from gsn_tpu_torch.graphs.batching import (iterate_batches,
                                               tight_epoch_caps)
    n = len(graphs)
    caps = tight_epoch_caps(np.arange(n), graphs, n)
    host = next(iterate_batches(graphs, n, caps=caps, y_shape=(),
                                y_dtype=np.float32))
    return host, host.to(dev)


def zinc_setup(dev):
    """Phase 2's batch and the main path's configuration,
    ``bench.py::zinc_cfg`` (ZINC GSN-EF): (graphs of
    ``make_zinc_like(1024)``, the batch on the host, on ``dev``,
    GSNConfig, TrainerConfig)."""
    from gsn_tpu_torch.config import GSNConfig
    from gsn_tpu_torch.data.synthetic import make_zinc_like
    from gsn_tpu_torch.train.loop import TrainerConfig
    graphs, d_id = make_zinc_like(1024)
    cfg = GSNConfig(
        model_name="GSN_edge_sparse", num_layers=4, d_out=D,
        out_features=1, msg_kind="general", id_scope="global",
        bn_mlp=False, id_embedding="one_hot_encoder",
        input_node_encoder="embedding", edge_encoder="embedding",
        readout="sum", in_features=1, d_in_node_encoder=[28],
        d_in_edge_encoder=[4], d_in_id=d_id)
    tcfg = TrainerConfig(lr=1e-3, batch_size=1024, scheduler="None",
                         loss_fn="L1Loss", prediction_fn="L1Loss")
    return (graphs, *one_batch(graphs, dev), cfg, tcfg)


def kernel_counters():
    """Every kernel wrapper of the port, by name (each carries its
    ``launches`` count; B4's ``graph_broadcast`` counts its calls, whose
    forwards are also in K4's count)."""
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    from gsn_tpu_torch.ops.cuda import slab_pool as k4
    from gsn_tpu_torch.ops.cuda import slab_weighted as b58
    fns = (k12.edge_message_fwd, k12.edge_message_bwd_recv,
           k3.segment_sum_sorted, k4.segment_broadcast, k4.graph_broadcast,
           b58.weighted_gather_fwd, b58.weighted_gather_bwd,
           b6.segment_minmax_fwd, b6.segment_minmax_bwd,
           b58.dgn_fused_fwd, b58.dgn_fused_bwd)
    return {fn.__name__: fn for fn in fns}


def dgn_batch(dev):
    """Phase 7's batch: (graphs of ``make_dgn_like(1024)``, their one
    batch on the host, the batch on ``dev``)."""
    from gsn_tpu_torch.data.synthetic import make_dgn_like
    graphs = make_dgn_like(1024)
    return (graphs, *one_batch(graphs, dev))


def dgn_operands(dev, data):
    """Phase 8's operands at the DGN shapes: (the batch's edge segments,
    its own weight columns W [E_real, K], node rows B [N, d] after relu
    (about half exact zeros, so maxima tie), cotangents g_w [N, K*d] and
    g_mm [N, 2d]), from seed 1."""
    from gsn_tpu_torch.nn.dgn import build_agg_ctx
    from gsn_tpu_torch.nn.models import edge_segments
    N, d, K = data.num_node_slots, DGN_D, DGN_K
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    B = torch.relu(rnd(N, d))
    g_w, g_mm = rnd(N, K * d), rnd(N, 2 * d)
    return (edge_segments(data), build_agg_ctx(DGN_AGGS, data, N).W, B, g_w,
            g_mm)


def dgn_kernel_calls(B, W, g_w, mm, cnt, g_mm, seg):
    """The six functions on K5/K6 in the main path's forms (the backward
    without dW), each as (kernel call, plain call)."""
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    from gsn_tpu_torch.ops.cuda import slab_weighted as b58
    rp, send = seg.recv_ptr, seg.send
    return {
        "weighted_gather_fwd": (
            lambda: b58.weighted_gather_fwd(B, W, rp, send),
            lambda: b58.weighted_gather_fwd_plain(B, W, rp, send)),
        "weighted_gather_bwd": (
            lambda: b58.weighted_gather_bwd(B, W, g_w, rp, send),
            lambda: b58.weighted_gather_bwd_plain(B, W, g_w, rp, send)),
        "segment_minmax_fwd": (
            lambda: b6.segment_minmax_fwd(B, rp, send),
            lambda: b6.segment_minmax_fwd_plain(B, rp, send)),
        "segment_minmax_bwd": (
            lambda: b6.segment_minmax_bwd(B, mm, cnt, g_mm, rp, send),
            lambda: b6.minmax_dh_plain(B, mm, cnt, g_mm, rp, send)),
        "dgn_fused_fwd": (
            lambda: b58.dgn_fused_fwd(B, W, rp, send),
            lambda: b58.dgn_fused_fwd_plain(B, W, rp, send)),
        "dgn_fused_bwd": (
            lambda: b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, rp, send),
            lambda: b58.dgn_fused_bwd_plain(B, W, g_w, mm, cnt, g_mm, rp,
                                            send)),
    }


def dgn_main_config(graphs):
    """bench.py::bench_dgn: the DGN main path's (DGNConfig,
    TrainerConfig)."""
    from gsn_tpu_torch.nn.dgn import DGNConfig, compute_avg_d
    from gsn_tpu_torch.train.loop import TrainerConfig
    cfg = DGNConfig(hidden_dim=DGN_D, out_dim=DGN_D, num_layers=4,
                    aggregators=DGN_AGGS, scalers=("identity",),
                    avg_d=compute_avg_d(graphs), dropout=0.3,
                    readout="mean", out_features=1)
    tcfg = TrainerConfig(lr=1e-3, batch_size=1024, scheduler="None",
                         loss_fn="BCEWithLogitsLoss", prediction_fn="None")
    return cfg, tcfg


def dgn_phases(dev, card, timed):
    """Phases 7-12 (see module docstring); returns (the kernel rows of
    K5/K6 in their three instantiations, the path's (graphs, batch on
    the card))."""
    from gsn_tpu_torch.graphs.batching import iterate_batches
    from gsn_tpu_torch.nn.dgn import (DGNConfig, DGNNet, build_dgn_model,
                                      compute_avg_d)
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    from gsn_tpu_torch.ops.cuda import slab_pool as k4
    from gsn_tpu_torch.ops.cuda import slab_weighted as b58
    from gsn_tpu_torch.train.loop import Trainer
    from gsn_tpu_torch.train.metrics import LOSSES

    # ---- phase 7: the DGN batch --------------------------------------------
    t0 = time.perf_counter()
    graphs, host, data = dgn_batch(dev)
    N, E = data.num_node_slots, data.num_edge_slots
    e_real = data.num_real_edges
    seg, W, B, g_w, g_mm = dgn_operands(dev, data)
    rp, send = seg.recv_ptr, seg.send
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    log(f"[dgn] data {time.perf_counter() - t0:.1f} s: graphs "
        f"{len(graphs)}, nodes {int(host.node_mask.sum())}/{N}, edges "
        f"{e_real}/{E}, vector field width {data.edge_eig.shape[1]}; "
        f"rows with edges: receivers {n_recv}, senders {n_send}")

    # ---- phase 8: K5/K6 against the plain versions -------------------------
    d, K = DGN_D, DGN_K
    if tuple(W.shape) != (E, K) or W[e_real:].any():   # a row a slot
        raise AssertionError(f"weight columns {tuple(W.shape)}")

    def dB_plain(dh):
        return k3.segment_sum_sorted_plain(dh, seg.send_ptr, seg.send_perm)

    errs = {}
    # B5 weighted_gather
    out_p = b58.weighted_gather_fwd_plain(B, W, rp, send)
    errs["weighted_gather_fwd"] = max_err(
        b58.weighted_gather_fwd(B, W, rp, send), out_p, FWD_RTOL, FWD_ATOL,
        "weighted_gather_fwd")
    err = 0.0
    for need_dw in (False, True):
        got = b58.weighted_gather_bwd(B, W, g_w, rp, send, need_dw)
        want = b58.weighted_gather_bwd_plain(B, W, g_w, rp, send, need_dw)
        err = max(err, grad_check(got[:1 + need_dw], want[:1 + need_dw],
                                  f"weighted_gather_bwd[dW={need_dw}]"))
    dh_p, dW_p = b58.weighted_gather_bwd_plain(B, W, g_w, rp, send, True)
    err = max(err, grad_check(
        fn_grads(lambda b, w: (b58.weighted_gather(b, w, seg),),
                 [B, W], [g_w]),
        [dB_plain(dh_p), dW_p], "WeightedGather"))
    errs["weighted_gather_bwd"] = err

    # B6 segment_minmax (B7's global max and tie counts folded in)
    mm, cnt = b6.segment_minmax_fwd(B, rp, send)
    mm_p, cnt_p = b6.segment_minmax_fwd_plain(B, rp, send)
    errs["segment_minmax_fwd"] = max_err(mm, mm_p, FWD_RTOL, FWD_ATOL,
                                         "segment_minmax_fwd")
    exact(cnt, cnt_p, "segment_minmax_fwd tie counts")
    tie_share = float((cnt_p > 1).float().mean())
    dh_mm = b6.minmax_dh_plain(B, mm_p, cnt_p, g_mm, rp, send)
    err = grad_check([b6.segment_minmax_bwd(B, mm, cnt, g_mm, rp, send)],
                     [dh_mm], "segment_minmax_bwd")
    err = max(err, grad_check(
        fn_grads(lambda b: (b6.segment_minmax(b, seg),), [B], [g_mm]),
        [dB_plain(dh_mm)], "SegmentMinmax"))
    errs["segment_minmax_bwd"] = err

    # B8 dgn_fused
    out, mm, cnt = b58.dgn_fused_fwd(B, W, rp, send)
    errs["dgn_fused_fwd"] = max(
        max_err(out, out_p, FWD_RTOL, FWD_ATOL, "dgn_fused_fwd out"),
        max_err(mm, mm_p, FWD_RTOL, FWD_ATOL, "dgn_fused_fwd mm"))
    exact(cnt, cnt_p, "dgn_fused_fwd tie counts")
    err = 0.0
    for need_dw in (False, True):
        got = b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, rp, send, need_dw)
        want = b58.dgn_fused_bwd_plain(B, W, g_w, mm_p, cnt_p, g_mm, rp,
                                       send, need_dw)
        err = max(err, grad_check(got[:1 + need_dw], want[:1 + need_dw],
                                  f"dgn_fused_bwd[dW={need_dw}]"))
    err = max(err, grad_check(
        fn_grads(lambda b, w: b58.dgn_fused(b, w, seg), [B, W],
                 [g_w, g_mm]),
        [dB_plain(dh_p + dh_mm), dW_p], "DGNFused"))
    errs["dgn_fused_bwd"] = err
    log(f"[dgn] kernels agree with their plain versions: {errs}; "
        f"share of tied [max, -min] columns {tie_share:.4f}")
    log(f"[dgn] stress shapes (empty rows, a 100-edge hub row): "
        f"{dgn_stress(dev)} width/K cases agree with the plain versions, "
        f"tie counts exact")
    log(dgn_ptxas_line(d, K))
    # K4 as the mean readout's backward at d=70 (float2 loads of g)
    g_graph = torch.randn(data.num_graph_slots, d, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
    log_row("dgn", f"segment_broadcast[mean-pool backward, d={d}]",
            k4_timed(timed, data, g_graph, k4.segment_broadcast,
                     k4.segment_broadcast_plain))

    # the library yardsticks: one PyTorch call each, checked against the
    # plain version.  S [N*K, N] and T [E, N*K] hold W as sparse CSR
    # matrices (rows v*K+k, and e), so S @ B is the weighted forward and
    # T @ g the weighted backward's dh; scatter_reduce gives [max, -min]
    # without the tie counts.
    recv = k12.receivers(rp)
    # the real edges' senders and weights (send and W span the slots)
    send_r, W_r = send[:e_real].long(), W[:e_real]
    vk = (recv[:, None] * K + torch.arange(K, device=dev)).reshape(-1)
    S = torch.sparse_coo_tensor(
        torch.stack([vk, send_r.repeat_interleave(K)]), W_r.reshape(-1),
        (N * K, N)).coalesce().to_sparse_csr()
    T = torch.sparse_coo_tensor(
        torch.stack([torch.arange(e_real, device=dev).repeat_interleave(K),
                     vk]), W_r.reshape(-1), (e_real, N * K)
    ).coalesce().to_sparse_csr()
    hc = torch.cat([B[send_r], -B[send_r]], dim=1)
    idx = recv[:, None].expand_as(hc)
    zeros_2d = torch.zeros(N, 2 * d, device=dev)
    library = {
        "weighted_gather_fwd": lambda: torch.sparse.mm(S, B),
        "weighted_gather_bwd": lambda: torch.sparse.mm(
            T, g_w.view(N * K, d)),
        "segment_minmax_fwd": lambda: zeros_2d.scatter_reduce(
            0, idx, hc, "amax", include_self=False),
    }
    max_err(library["weighted_gather_fwd"]().view(N, K * d), out_p,
            FWD_RTOL, FWD_ATOL, "library weighted forward")
    max_err(library["weighted_gather_bwd"](), dh_p[:e_real], FWD_RTOL,
            FWD_ATOL, "library weighted dh")
    max_err(library["segment_minmax_fwd"](), mm_p, FWD_RTOL, FWD_ATOL,
            "library scatter max")

    # bounds: B at the senders with edges, W, recv_ptr and send read
    # once; every output row written once; the backward's node-level
    # operands (g_w, mm, cnt, g_mm) at the receivers with edges, and dh
    # at every real edge.  The main path's backward takes no dW (the
    # weights do not need a gradient); its weighted-only part reads no B.
    f32 = 4
    walk = f32 * (n_send * d + N + 1 + e_real)
    kd, mm_w = K * d, 2 * d
    costs = {
        "weighted_gather_fwd": (walk + f32 * (e_real * K + N * kd),
                                2 * K * d * e_real),
        "weighted_gather_bwd": (f32 * (e_real * K + n_recv * kd + N + 1
                                       + e_real * d), 2 * K * d * e_real),
        "segment_minmax_fwd": (walk + f32 * 2 * N * mm_w, 2 * d * e_real),
        "segment_minmax_bwd": (walk + f32 * (3 * n_recv * mm_w
                                             + e_real * d), 4 * d * e_real),
        "dgn_fused_fwd": (walk + f32 * (e_real * K + N * kd + 2 * N * mm_w),
                          (2 * K + 2) * d * e_real),
        "dgn_fused_bwd": (walk + f32 * (e_real * K + n_recv * (kd + 3 * mm_w)
                                        + e_real * d),
                          (2 * K + 4) * d * e_real),
    }
    calls = dgn_kernel_calls(B, W, g_w, mm, cnt, g_mm, seg)
    replaces = {
        "weighted_gather_fwd": "gsn_tpu/ops/pallas/slab_weighted.py:76",
        "weighted_gather_bwd": "gsn_tpu/ops/pallas/slab_weighted.py:102",
        "segment_minmax_fwd": "gsn_tpu/ops/pallas/slab_minmax.py:119",
        "segment_minmax_bwd": "gsn_tpu/ops/pallas/slab_minmax.py:140",
        "dgn_fused_fwd": "gsn_tpu/ops/pallas/slab_weighted.py:294",
        "dgn_fused_bwd": "gsn_tpu/ops/pallas/slab_weighted.py:315",
    }
    # B7 (slab_combine_minmax_cnt) has no slabs to combine here: its
    # global max and tie count come out of the minmax forwards
    folds = {"segment_minmax_fwd": "gsn_tpu/ops/pallas/slab_combine.py:119",
             "dgn_fused_fwd": "gsn_tpu/ops/pallas/slab_combine.py:119"}
    rows = {}
    for name, (kernel, plain) in calls.items():
        t_b, by = bound(*costs[name])
        rows[name] = dict(
            source="gsn_tpu_torch/csrc/dgn_aggregate.cu",
            replaces=replaces[name], max_abs_err=errs[name], bound_ms=t_b,
            bound_by=by, **timed(kernel, plain, library.get(name)))
        if name in folds:
            rows[name]["folds"] = folds[name]
    torch.cuda.synchronize()

    # ---- phase 9: small models, card vs CPU, one per dispatch branch -------
    avg_d = compute_avg_d(graphs)
    bce = LOSSES["BCEWithLogitsLoss"]
    small = next(iterate_batches(graphs[:64], 64, y_shape=(),
                                 y_dtype=np.float32))
    counters = kernel_counters()
    branch_kernels = {"fused": ("dgn_fused_fwd", "dgn_fused_bwd"),
                      "weighted": ("weighted_gather_fwd",
                                   "weighted_gather_bwd"),
                      "minmax": ("segment_minmax_fwd", "segment_minmax_bwd")}
    for branch, aggs in DGN_BRANCHES.items():
        cfg = DGNConfig(hidden_dim=d, out_dim=d, num_layers=2,
                        aggregators=aggs, avg_d=avg_d, dropout=0.0)
        ref = build_dgn_model(cfg, torch.Generator().manual_seed(2))
        preds, grads = {}, {}
        for where in ("cpu", "cuda"):
            m = copy.deepcopy(ref).to(where).train()
            b = small.to(where)
            before = {k: counters[k].launches for k in branch_kernels[branch]}
            y_hat = m(b)
            bce(y_hat, b.y, b.graph_mask).backward()
            preds[where] = y_hat.detach().cpu()
            grads[where] = [p.grad.detach().cpu() for p in m.parameters()]
            ran = {k: counters[k].launches - n for k, n in before.items()}
            want = cfg.num_layers if where == "cuda" else 0
            if any(n != want for n in ran.values()):
                raise AssertionError(f"{branch} branch on {where}: "
                                     f"launches {ran}, expected {want} each")
        err = max(max_err(preds["cuda"], preds["cpu"], FWD_RTOL, FWD_ATOL,
                          f"DGN {branch} prediction (card vs CPU)"),
                  grad_check(grads["cuda"], grads["cpu"],
                             f"DGN {branch} gradients (card vs CPU)"))
        log(f"[dgn] {branch} branch {aggs}: model on the card vs the CPU "
            f"max abs err {err}")

    # ---- phase 10: the DGN main path (bench.py::bench_dgn) -----------------
    cfg, tcfg = dgn_main_config(graphs)
    trainer = Trainer(cfg, tcfg, graphs, model=DGNNet(cfg))
    state = trainer.init_state(seed=0)
    L = cfg.num_layers
    # K3: the node sums of build_agg_ctx, the mean readout and each
    # layer's dB; K4: the readout's backward
    per_step = {"dgn_fused_fwd": L, "dgn_fused_bwd": L,
                "segment_sum_sorted": L + 2, "segment_broadcast": 1}
    torch.cuda.reset_peak_memory_stats()
    state, losses, step_s, launches, _ = train_steps(trainer, state, data,
                                                     STEPS, counters)
    log(f"[dgn] losses {losses}")
    log(f"[dgn] launches in {STEPS} steps: {launches}")
    expect_launches(launches, per_step, STEPS, "DGN path")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"DGN loss did not fall: {losses}")
    for name in ("dgn_fused_fwd", "dgn_fused_bwd"):
        rows[name].update(launches=launches[name], path="dgn")
    med = statistics.median(step_s[1:])
    log(f"[dgn] train step median {med * 1e3:.3f} ms over {STEPS - 1} "
        f"steps (first {step_s[0] * 1e3:.1f} ms), "
        f"{e_real / med:.4e} real edges/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")

    # ---- phase 11: the weighted-only and minmax-only paths -----------------
    for branch in ("weighted", "minmax"):
        cfg_b = dataclasses.replace(cfg, aggregators=DGN_BRANCHES[branch])
        tr = Trainer(cfg_b, tcfg, graphs, model=DGNNet(cfg_b))
        fwd, bwd = branch_kernels[branch]
        b_state, b_losses, b_s, b_launches, _ = train_steps(
            tr, tr.init_state(seed=0), data, BRANCH_STEPS, counters)
        expect_launches(b_launches, {fwd: L, bwd: L,
                                     "segment_sum_sorted": L + 2,
                                     "segment_broadcast": 1},
                        BRANCH_STEPS, f"DGN {branch} path")
        for name in (fwd, bwd):
            rows[name].update(launches=b_launches[name],
                              path=f"dgn-{branch}")
        log(f"[dgn] {branch} path: losses {b_losses}, launches "
            f"{b_launches}, median step "
            f"{statistics.median(b_s[1:]) * 1e3:.3f} ms")

    # ---- phase 12 ----------------------------------------------------------
    profile_steps(trainer, state, data, med * 1e3, "dgn")
    return rows, (graphs, data)


def molhiv_cfg(d_id):
    """``bench.py::molhiv_cfg`` (GSN-VN-AF) for an id vocabulary of
    ``d_id``."""
    from gsn_tpu_torch.config import GSNConfig
    return GSNConfig(
        model_name="GSN_edge_sparse_ogb", num_layers=5, d_out=MOLHIV_D,
        d_h=2 * MOLHIV_D, out_features=1, msg_kind="ogb", id_scope="local",
        vn=True, dropout_features=0.5, readout="mean",
        final_projection=[False], jk_mlp=False, id_embedding="embedding",
        d_out_id_embedding=MOLHIV_D, input_node_encoder="atom_encoder",
        edge_encoder="bond_encoder", input_vn_encoder="embedding",
        in_features=9, in_edge_features=3, d_in_id=d_id)


def molhiv_setup(dev):
    """Phase 13's batch and the molhiv path's configuration,
    ``bench.py::molhiv_cfg`` (GSN-VN-AF): (graphs of
    ``make_molhiv_like(1024)``, the batch on the host, on ``dev``,
    GSNConfig, TrainerConfig)."""
    from gsn_tpu_torch.data.synthetic import make_molhiv_like
    from gsn_tpu_torch.train.loop import TrainerConfig
    graphs, d_id = make_molhiv_like(1024)
    cfg = molhiv_cfg(d_id)
    tcfg = TrainerConfig(lr=1e-3, batch_size=1024, scheduler="None",
                         loss_fn="BCEWithLogitsLoss", prediction_fn="None")
    return (graphs, *one_batch(graphs, dev), cfg, tcfg)


def molhiv_phases(dev, card, timed):
    """Phases 13-17 (see module docstring); returns (B4's kernel rows,
    the path's (graphs, batch on the card, GSNConfig, TrainerConfig))."""
    from gsn_tpu_torch.graphs.batching import iterate_batches
    from gsn_tpu_torch.nn.models import build_model, edge_segments
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.ops.cuda import slab_pool as k4
    from gsn_tpu_torch.train.loop import Trainer
    from gsn_tpu_torch.train.metrics import LOSSES

    # ---- phase 13: the molhiv batch ----------------------------------------
    t0 = time.perf_counter()
    graphs, host, data, cfg, tcfg = molhiv_setup(dev)
    N, E, G = data.num_node_slots, data.num_edge_slots, data.num_graph_slots
    e_real = data.num_real_edges
    seg = edge_segments(data)
    rp, send, gp = seg.recv_ptr, seg.send, data.graph_ptr
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    g_full = int((gp.diff() > 0).sum())
    log(f"[molhiv] data {time.perf_counter() - t0:.1f} s: graphs "
        f"{len(graphs)}, nodes {int(host.node_mask.sum())}/{N}, edges "
        f"{e_real}/{E}, graph slots {G} ({g_full} with nodes), id vocab "
        f"{cfg.d_in_id}; rows with edges: receivers {n_recv}, senders {n_send}")

    # ---- phase 14: B4 and the ogb form of K1/K2 ----------------------------
    d = MOLHIV_D
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    vn, g_node = rnd(G, d), rnd(N, d)
    B, Pe, b1 = rnd(N, d), rnd(E, d), torch.zeros(d, device=dev)
    out = k4.graph_broadcast(vn, gp, N)
    exact(out, k4.graph_broadcast_plain(vn, gp, N), "graph_broadcast")
    if out[~data.node_mask].any():
        raise AssertionError("graph_broadcast: padding rows are not 0")
    leaves = [vn.clone().requires_grad_(True) for _ in range(2)]
    err = grad_check(
        torch.autograd.grad((k4.graph_broadcast(leaves[0], gp, N)
                             * g_node).sum(), leaves[:1]),
        torch.autograd.grad((k4.graph_broadcast_plain(leaves[1], gp, N)
                             * g_node).sum(), leaves[1:]),
        "GraphBroadcast")
    msg_err = max_err(
        k12.edge_message_fwd(None, B, Pe, b1, rp, send),
        k12.edge_message_fwd_plain(None, B, Pe, b1, rp, send),
        FWD_RTOL, FWD_ATOL, "edge_message_fwd[ogb]")
    dH, dA = k12.edge_message_bwd_recv(None, B, Pe, b1, g_node, rp, send,
                                       "relu", E)
    dH_p, _ = k12.edge_message_bwd_recv_plain(None, B, Pe, b1, g_node, rp,
                                              send, "relu", E)
    if dA is not None:
        raise AssertionError("edge_message_bwd_recv[ogb] returned dA")
    msg_err = max(msg_err, max_err(dH, dH_p, FWD_RTOL, FWD_ATOL,
                                   "edge_message_bwd_recv[ogb] dH"))
    leaves = [t.clone().requires_grad_(True) for t in (B, Pe)]
    ref = [t.clone().requires_grad_(True) for t in (B, Pe)]
    msg_err = max(msg_err, grad_check(
        torch.autograd.grad((k12.edge_message_aggregate(
            None, *leaves, b1, seg, "relu") * g_node).sum(), leaves),
        torch.autograd.grad((k12.edge_message_fwd_plain(
            None, *ref, b1, rp, send) * g_node).sum(), ref),
        "EdgeMessageAggregate[ogb]"))
    log(f"[molhiv] at d={d}: B4's forward equals its plain version bit for "
        f"bit (padding rows 0), its backward max abs err {err}; K1/K2 in "
        f"the ogb form max abs err {msg_err}")

    # B4 (its row; the backward's error in max_abs_err), then K4 as the
    # virtual node's sum-pool backward on a log line of its own
    row = dict(source="gsn_tpu_torch/csrc/segment_broadcast.cu",
               replaces="gsn_tpu/ops/pallas/slab_pool.py:201",
               **k4_timed(timed, data, vn, k4.graph_broadcast,
                          k4.graph_broadcast_plain))
    row["max_abs_err"] = err
    log_row("molhiv", f"segment_broadcast[pool backward, d={d}]",
            k4_timed(timed, data, rnd(G, d), k4.segment_broadcast,
                     k4.segment_broadcast_plain))
    # the ogb form of K1/K2 and B4's backward (K3 over graph_ptr), on
    # log lines of their own (their rows hold the zinc path's form)
    n_real = int(data.node_mask.sum())
    zeros_gd = torch.zeros(G, d, device=dev)
    batch_l = data.batch[:n_real].long()
    extra = {
        "edge_message_fwd[ogb]": (
            (lambda: k12.edge_message_fwd(None, B, Pe, b1, rp, send)),
            (lambda: k12.edge_message_fwd_plain(None, B, Pe, b1, rp, send)),
            None,
            bound(4 * ((n_send + N) * d + e_real * d + d + N + 1 + e_real),
                  3 * e_real * d)),
        "edge_message_bwd_recv[ogb]": (
            (lambda: k12.edge_message_bwd_recv(None, B, Pe, b1, g_node, rp,
                                               send, "relu", E)),
            (lambda: k12.edge_message_bwd_recv_plain(
                None, B, Pe, b1, g_node, rp, send, "relu", E)),
            None,
            bound(4 * ((n_recv + n_send) * d + e_real * d + E * d + d + N
                       + 1 + e_real), 3 * e_real * d)),
        "graph_broadcast backward (K3)": (
            (lambda: k3.segment_sum_sorted(g_node, gp)),
            (lambda: k3.segment_sum_sorted_plain(g_node, gp)),
            (lambda: torch.index_add(zeros_gd, 0, batch_l,
                                     g_node[:n_real])),
            bound(4 * (n_real * d + G * d + G + 1), n_real * d)),
    }
    for name, (kernel, plain, library, (t_x, by_x)) in extra.items():
        log_row("molhiv", name, dict(**timed(kernel, plain, library),
                                     bound_ms=t_x, bound_by=by_x))
    torch.cuda.synchronize()

    # ---- phase 15: a small GNN_OGB, card vs CPU ----------------------------
    counters = kernel_counters()
    bce = LOSSES["BCEWithLogitsLoss"]
    small_cfg = dataclasses.replace(
        cfg, num_layers=2, d_out=32, d_h=64, d_out_id_embedding=32,
        dropout_features=0.0)
    small = next(iterate_batches(graphs[:60], 64, y_shape=(),
                                 y_dtype=np.float32))
    ref_model = build_model(small_cfg, torch.Generator().manual_seed(3))
    preds, grads = {}, {}
    for where in ("cpu", "cuda"):
        m = copy.deepcopy(ref_model).to(where).train()
        b = small.to(where)
        before = {k: counters[k].launches
                  for k in ("graph_broadcast", "edge_message_fwd")}
        y_hat = m(b)
        bce(y_hat, b.y, b.graph_mask).backward()
        preds[where] = y_hat.detach().cpu()
        grads[where] = [p.grad.detach().cpu() for p in m.parameters()]
        ran = {k: counters[k].launches - n for k, n in before.items()}
        want = small_cfg.num_layers if where == "cuda" else 0
        if any(n != want for n in ran.values()):
            raise AssertionError(f"small GNN_OGB on {where}: launches "
                                 f"{ran}, expected {want} each")
    small_err = max(max_err(preds["cuda"], preds["cpu"], FWD_RTOL, FWD_ATOL,
                            "GNN_OGB prediction (card vs CPU)"),
                    grad_check(grads["cuda"], grads["cpu"],
                               "GNN_OGB gradients (card vs CPU)"))
    log(f"[molhiv] small GNN_OGB on the card vs the CPU: max abs err "
        f"{small_err}")

    # ---- phase 16: the molhiv main path (bench.py::molhiv_cfg) -------------
    trainer = Trainer(cfg, tcfg, graphs)
    state = trainer.init_state(seed=0)
    L = cfg.num_layers
    # K3: each layer's dB, the L-1 VN sum pools and the mean readout, and
    # each B4 backward; K4: each B4 forward and each pool's backward
    per_step = {"edge_message_fwd": L, "edge_message_bwd_recv": L,
                "graph_broadcast": L, "segment_broadcast": 2 * L,
                "segment_sum_sorted": 3 * L}
    torch.cuda.reset_peak_memory_stats()
    state, losses, step_s, launches, _ = train_steps(trainer, state, data,
                                                     STEPS, counters)
    log(f"[molhiv] losses {losses}")
    log(f"[molhiv] launches in {STEPS} steps: {launches}")
    expect_launches(launches, per_step, STEPS, "molhiv path")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"molhiv loss did not fall: {losses}")
    row.update(launches=launches["graph_broadcast"], path="molhiv")
    med = statistics.median(step_s[1:])
    log(f"[molhiv] train step median {med * 1e3:.3f} ms over {STEPS - 1} "
        f"steps (first {step_s[0] * 1e3:.1f} ms), "
        f"{e_real / med:.4e} real edges/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")

    # ---- phase 17 ----------------------------------------------------------
    profile_steps(trainer, state, data, med * 1e3, "molhiv")
    return {"graph_broadcast": row}, (graphs, data, cfg, tcfg)

def bf16_zinc_kernels(dev, timed, data):
    """Phase 18 (see module docstring): K1-K4 in bf16 at the zinc path's
    shapes (d=128); returns their kernel rows."""
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.ops.cuda import slab_pool as k4

    N, E, G = data.num_node_slots, data.num_edge_slots, data.num_graph_slots
    e_real, gp = data.num_real_edges, data.graph_ptr
    n_real = int(data.node_mask.sum())
    seg = edge_segments(data)
    rp, send = seg.recv_ptr, seg.send
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    n_dst = seg.send_ptr.numel() - 1
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    A, B, Pe, g_node, g_graph = (rnd(N, D), rnd(N, D), rnd(E, D),
                                 rnd(N, D), rnd(G, D))
    b1 = torch.randn(D, device=dev, generator=gen)
    src = "gsn_tpu_torch/csrc/"
    rows = {}
    # K1: bf16 data, 2-byte rows; b1 and the indices 4 bytes
    err = max(bf16_check(
        k12.edge_message_fwd(A, B, Pe, b1, rp, send, act),
        k12.edge_message_fwd_plain(A, B, Pe, b1, rp, send, act),
        f"edge_message_fwd[bf16 {act}]") for act in ("relu", "identity"))
    t_b, by = bound(2 * ((n_recv + n_send + N) * D + e_real * D)
                    + 4 * (D + N + 1 + e_real), 5 * e_real * D)
    rows["edge_message_fwd[bf16]"] = dict(
        source=src + "edge_message.cu",
        replaces="gsn_tpu/ops/pallas/slab_message.py:214",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k12.edge_message_fwd(A, B, Pe, b1, rp, send),
                lambda: k12.edge_message_fwd_plain(A, B, Pe, b1, rp, send)))
    # K2: dH (a masked copy of g) bit for bit, dA one ulp
    err = 0.0
    for act in ("relu", "identity"):
        dH, dA = k12.edge_message_bwd_recv(A, B, Pe, b1, g_node, rp, send,
                                           act, E)
        dH_p, dA_p = k12.edge_message_bwd_recv_plain(A, B, Pe, b1, g_node,
                                                     rp, send, act, E)
        exact(dH, dH_p, f"edge_message_bwd_recv[bf16 {act}] dH")
        err = max(err, bf16_check(dA, dA_p,
                                  f"edge_message_bwd_recv[bf16 {act}] dA"))
    t_b, by = bound(2 * ((2 * n_recv + n_send + N) * D + e_real * D + E * D)
                    + 4 * (D + N + 1 + e_real), 5 * e_real * D)
    rows["edge_message_bwd_recv[bf16]"] = dict(
        source=src + "edge_message.cu",
        replaces="gsn_tpu/ops/pallas/slab_message.py:240",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k12.edge_message_bwd_recv(A, B, Pe, b1, g_node, rp,
                                                  send, "relu", E),
                lambda: k12.edge_message_bwd_recv_plain(
                    A, B, Pe, b1, g_node, rp, send, "relu", E)))
    # K3 bf16 -> bf16: the sender-side dB
    sp, perm = seg.send_ptr, seg.send_perm
    bf = torch.bfloat16
    err = bf16_check(k3.segment_sum_sorted(dH, sp, perm, bf),
                     k3.segment_sum_sorted_plain(dH, sp, perm, bf),
                     "segment_sum_sorted[bf16->bf16]")
    t_b, by = bound(2 * (e_real + n_dst) * D + 4 * (n_dst + 1 + e_real),
                    e_real * D)
    rows["segment_sum_sorted[bf16->bf16]"] = dict(
        source=src + "segment_sum.cu",
        replaces="gsn_tpu/ops/pallas/slab_combine.py:77",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k3.segment_sum_sorted(dH, sp, perm, bf),
                lambda: k3.segment_sum_sorted_plain(dH, sp, perm, bf)))
    # K3 bf16 -> f32: the readout pool (f32 sums of the same bf16 values)
    err = max_err(k3.segment_sum_sorted(A, gp),
                  k3.segment_sum_sorted_plain(A, gp), FWD_RTOL, FWD_ATOL,
                  "segment_sum_sorted[bf16->f32]")
    t_b, by = bound(2 * n_real * D + 4 * (G * D + G + 1), n_real * D)
    rows["segment_sum_sorted[bf16->f32]"] = dict(
        source=src + "segment_sum.cu",
        replaces="gsn_tpu/ops/pallas/slab_pool.py:84",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k3.segment_sum_sorted(A, gp),
                lambda: k3.segment_sum_sorted_plain(A, gp),
                # one segment_reduce call sums bf16 rows into bf16, not
                # f32: a time beside the row, not its library call
                also={"segment_reduce_ms": lambda: torch.segment_reduce(
                    A[:n_real], "sum", offsets=gp.long())}))
    # K4: the pool backward, bit for bit
    rows["segment_broadcast[bf16 d=128]"] = dict(
        source=src + "segment_broadcast.cu",
        replaces="gsn_tpu/ops/pallas/slab_pool.py:90",
        **k4_timed(timed, data, g_graph, k4.segment_broadcast,
                   k4.segment_broadcast_plain))
    # the autograd Functions: each gradient in its input's dtype
    leaves = [t.clone().requires_grad_(True) for t in (A, B, Pe, b1)]
    got = torch.autograd.grad((k12.edge_message_aggregate(
        *leaves, seg, "relu").float() * g_node.float()).sum(), leaves)
    dH_p, dA_p = k12.edge_message_bwd_recv_plain(A, B, Pe, b1, g_node, rp,
                                                 send, "relu", E)
    fn_err = max(bf16_check(got[0], dA_p, "EdgeMessageAggregate[bf16] dA"),
                 bf16_check(got[1], k3.segment_sum_sorted_plain(
                     dH_p, sp, perm, bf), "EdgeMessageAggregate[bf16] dB"))
    exact(got[2], dH_p, "EdgeMessageAggregate[bf16] dPe")
    fn_err = max(fn_err, max_err(got[3], dH_p.float().sum(0), GRAD_RTOL,
                                 1e-4 * float(dH_p.float().abs().max()),
                                 "EdgeMessageAggregate[bf16] db1"))
    x = A.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad((k4.add_pool(x, gp)
                                 * g_graph.float()).sum(), [x])
    exact(dx, k4.segment_broadcast_plain(g_graph, gp, N),
          "AddPool[bf16] backward")
    log(f"[bf16] zinc shapes (d={D}): K1-K4 agree with their plain "
        f"versions (K4, dH, dPe and AddPool's backward bit for bit); "
        f"autograd max abs err {fn_err}")
    torch.cuda.synchronize()
    return rows


def bf16_molhiv_kernels(dev, timed, data):
    """Phase 19 (see module docstring): B4, K4 and K1/K2 in the ogb form
    in bf16 at the molhiv path's shapes (d=300); returns their rows."""
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.ops.cuda import slab_pool as k4

    N, E, G = data.num_node_slots, data.num_edge_slots, data.num_graph_slots
    e_real, gp, d = data.num_real_edges, data.graph_ptr, MOLHIV_D
    n_real = int(data.node_mask.sum())
    seg = edge_segments(data)
    rp, send = seg.recv_ptr, seg.send
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    gen = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    vn, g_node, B, Pe = rnd(G, d), rnd(N, d), rnd(N, d), rnd(E, d)
    b1 = torch.zeros(d, device=dev)
    bf = torch.bfloat16
    src = "gsn_tpu_torch/csrc/"
    rows = {}
    # B4: forward a bit copy (padding rows 0), backward K3 bf16 -> bf16
    out = k4.graph_broadcast(vn, gp, N)
    exact(out, k4.graph_broadcast_plain(vn, gp, N), "graph_broadcast[bf16]")
    if out[~data.node_mask].any():
        raise AssertionError("graph_broadcast[bf16]: padding rows are not 0")
    vl = vn.clone().requires_grad_(True)
    (dv,) = torch.autograd.grad((k4.graph_broadcast(vl, gp, N).float()
                                 * g_node.float()).sum(), [vl])
    b4_err = bf16_check(dv, k3.segment_sum_sorted_plain(g_node, gp,
                                                         out_dtype=bf),
                        "graph_broadcast[bf16] backward")
    rows["graph_broadcast[bf16]"] = dict(
        source=src + "segment_broadcast.cu",
        replaces="gsn_tpu/ops/pallas/slab_pool.py:201",
        **k4_timed(timed, data, vn, k4.graph_broadcast,
                   k4.graph_broadcast_plain))
    rows["graph_broadcast[bf16]"]["max_abs_err"] = b4_err
    rows["segment_broadcast[bf16 d=300]"] = dict(
        source=src + "segment_broadcast.cu",
        replaces="gsn_tpu/ops/pallas/slab_pool.py:90",
        **k4_timed(timed, data, rnd(G, d), k4.segment_broadcast,
                   k4.segment_broadcast_plain))
    # K1/K2 in the ogb form: no A side, Pe, relu, a constant zero b1
    err = bf16_check(k12.edge_message_fwd(None, B, Pe, b1, rp, send),
                     k12.edge_message_fwd_plain(None, B, Pe, b1, rp, send),
                     "edge_message_fwd[bf16 ogb]")
    t_b, by = bound(2 * ((n_send + N) * d + e_real * d)
                    + 4 * (d + N + 1 + e_real), 3 * e_real * d)
    rows["edge_message_fwd[bf16 ogb]"] = dict(
        source=src + "edge_message.cu",
        replaces="gsn_tpu/ops/pallas/slab_message.py:214",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k12.edge_message_fwd(None, B, Pe, b1, rp, send),
                lambda: k12.edge_message_fwd_plain(None, B, Pe, b1, rp,
                                                   send)))
    dH, dA = k12.edge_message_bwd_recv(None, B, Pe, b1, g_node, rp, send,
                                       "relu", E)
    dH_p, _ = k12.edge_message_bwd_recv_plain(None, B, Pe, b1, g_node, rp,
                                              send, "relu", E)
    if dA is not None:
        raise AssertionError("edge_message_bwd_recv[bf16 ogb] returned dA")
    exact(dH, dH_p, "edge_message_bwd_recv[bf16 ogb] dH")
    leaves = [t.clone().requires_grad_(True) for t in (B, Pe)]
    got = torch.autograd.grad((k12.edge_message_aggregate(
        None, *leaves, b1, seg, "relu").float() * g_node.float()).sum(),
        leaves)
    err = bf16_check(got[0], k3.segment_sum_sorted_plain(
        dH_p, seg.send_ptr, seg.send_perm, bf),
        "EdgeMessageAggregate[bf16 ogb] dB")
    exact(got[1], dH_p, "EdgeMessageAggregate[bf16 ogb] dPe")
    t_b, by = bound(2 * ((n_recv + n_send) * d + e_real * d + E * d)
                    + 4 * (d + N + 1 + e_real), 3 * e_real * d)
    rows["edge_message_bwd_recv[bf16 ogb]"] = dict(
        source=src + "edge_message.cu",
        replaces="gsn_tpu/ops/pallas/slab_message.py:240",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k12.edge_message_bwd_recv(None, B, Pe, b1, g_node,
                                                  rp, send, "relu", E),
                lambda: k12.edge_message_bwd_recv_plain(
                    None, B, Pe, b1, g_node, rp, send, "relu", E)))
    # B4's backward and the pool at d=300, on log lines of their own
    extra = {
        "graph_broadcast[bf16] backward (K3 bf16->bf16)": (
            (lambda: k3.segment_sum_sorted(g_node, gp, out_dtype=bf)),
            (lambda: k3.segment_sum_sorted_plain(g_node, gp, out_dtype=bf)),
            bound(2 * (n_real + G) * d + 4 * (G + 1), n_real * d)),
        "segment_sum_sorted[bf16->f32, pool d=300]": (
            (lambda: k3.segment_sum_sorted(g_node, gp)),
            (lambda: k3.segment_sum_sorted_plain(g_node, gp)),
            bound(2 * n_real * d + 4 * (G * d + G + 1), n_real * d)),
    }
    max_err(k3.segment_sum_sorted(g_node, gp),
            k3.segment_sum_sorted_plain(g_node, gp), FWD_RTOL, FWD_ATOL,
            "segment_sum_sorted[bf16->f32, d=300]")
    for name, (kernel, plain, (t_x, by_x)) in extra.items():
        log_row("bf16", name, dict(**timed(kernel, plain), bound_ms=t_x,
                                   bound_by=by_x))
    log(f"[bf16] molhiv shapes (d={d}): B4, K4 and K1/K2 in the ogb form "
        f"agree with their plain versions (B4's forward, K4, dH and dPe "
        f"bit for bit); B4 backward max abs err {b4_err}")
    torch.cuda.synchronize()
    return rows


def cosine(a, b):
    a = torch.cat([t.float().reshape(-1) for t in a])
    b = torch.cat([t.float().reshape(-1) for t in b])
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def bf16_card_vs_cpu(ref, small, loss_fn, what, modes, min_launches,
                     ref_f32=None):
    """A bf16 model ``ref`` on the batch ``small``, the card (kernels)
    against the CPU (plain versions) from the same weights: loss rel
    BF16_LOSS_REL and the all-parameter gradient cosine above
    BF16_COSINE; each kernel named in ``modes`` must launch at least
    ``min_launches`` times in its mode there, and never on the CPU.

    With ``ref_f32``, the same model in f32, the cosine gate is the
    smaller of BF16_COSINE and the cosine of the CPU's bf16 gradient with
    the f32 one: where bf16 itself turns the gradient further than 0.99
    from f32 (training through the BN statistics of a fused-BN message),
    the card must not turn it further from the CPU than that."""
    counters = kernel_counters()
    losses, grads = {}, {}
    for where in ("cpu", "cuda"):
        m = copy.deepcopy(ref).to(where).train()
        b = small.to(where)
        before = {k: counters[k].modes.get(mode, 0)
                  for k, mode in modes.items()}
        loss = loss_fn(m(b), b.y, b.graph_mask)
        loss.backward()
        losses[where] = loss.item()
        grads[where] = [p.grad.detach().cpu() for p in m.parameters()]
        ran = {k: counters[k].modes.get(mode, 0) - before[k]
               for k, mode in modes.items()}
        if where == "cuda" and min(ran.values()) < min_launches:
            raise AssertionError(f"{what} bf16 on the card: launches {ran} "
                                 f"in modes {modes}")
        if where == "cpu" and any(ran.values()):
            raise AssertionError(f"{what} bf16 on the CPU launched {ran}")
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    cos = cosine(grads["cuda"], grads["cpu"])
    gate, against_f32 = BF16_COSINE, ""
    if ref_f32 is not None:
        m, b = copy.deepcopy(ref_f32).train(), small.to("cpu")
        loss_fn(m(b), b.y, b.graph_mask).backward()
        cos_f32 = cosine(grads["cpu"], [p.grad for p in m.parameters()])
        gate = min(BF16_COSINE, cos_f32)
        against_f32 = (f"; the CPU's bf16 gradient against its f32 one "
                       f"cosine {cos_f32:.6f}, so the gate is {gate:.6f}")
    if not (rel <= BF16_LOSS_REL and cos > gate):
        raise AssertionError(f"{what} bf16 card vs CPU: loss rel {rel}, "
                             f"gradient cosine {cos} (gate {gate})")
    log(f"[bf16] small {what} on the card vs the CPU: losses "
        f"{losses['cuda']} / {losses['cpu']} (rel {rel:.3e}), gradient "
        f"cosine {cos:.6f}{against_f32}")


def bf16_small_model(cfg, graphs, n_slots, loss_fn, seed, what,
                     modes=None, f32_gate=False):
    """Phases 20 and 27: a bf16 GSN model on a small batch through
    ``bf16_card_vs_cpu`` (with its f32 twin when ``f32_gate``); by
    default K1 and K4 must launch in bf16 once a layer or more on the
    card."""
    from gsn_tpu_torch.graphs.batching import iterate_batches
    from gsn_tpu_torch.nn.models import build_model
    small = next(iterate_batches(graphs, n_slots, y_shape=(),
                                 y_dtype=np.float32))
    ref = build_model(cfg, torch.Generator().manual_seed(seed))
    ref_f32 = None
    if f32_gate:
        ref_f32 = build_model(dataclasses.replace(cfg, compute_dtype=None))
        ref_f32.load_state_dict(ref.state_dict())
    bf16_card_vs_cpu(ref, small, loss_fn, what,
                     modes or {"edge_message_fwd": "bf16",
                               "segment_broadcast": "bf16"}, cfg.num_layers,
                     ref_f32)


def bf16_path(card, setup, per_step, per_step_modes, tag, over=None,
              model=None):
    """Phases 21-22, 25 and 28: ``setup``'s configuration in bf16 (with
    the fields ``over``, and trained as ``model(cfg)`` when a model class
    is given) takes STEPS steps through ``Trainer.train_step``, counters
    zeroed just before and read just after, each kernel exactly its
    launches a step in its modes; then the path's profile.  Returns the
    launches by name and mode."""
    from gsn_tpu_torch.train.loop import Trainer
    graphs, data, cfg, tcfg = setup
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", **(over or {}))
    trainer = Trainer(cfg, tcfg, graphs,
                      model=model(cfg) if model is not None else None)
    state = trainer.init_state(seed=0)
    torch.cuda.reset_peak_memory_stats()
    state, losses, step_s, launches, modes = train_steps(
        trainer, state, data, STEPS, kernel_counters())
    log(f"[{tag}] losses {losses}")
    log(f"[{tag}] launches in {STEPS} steps: {launches}; by mode: "
        f"{ {k: v for k, v in modes.items() if v} }")
    expect_launches(launches, per_step, STEPS, f"{tag} path", modes,
                    per_step_modes)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} loss did not fall: {losses}")
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError(f"{tag}: a parameter left f32")
    med = statistics.median(step_s[1:])
    log(f"[{tag}] train step median {med * 1e3:.3f} ms over {STEPS - 1} "
        f"steps (first {step_s[0] * 1e3:.1f} ms), "
        f"{data.num_real_edges / med:.4e} real edges/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    profile_steps(trainer, state, data, med * 1e3, tag)
    return modes


def f32_ulp(got, want, what):
    """An f32 output summed from bf16 values against its plain version's,
    within one bf16 ulp (BF16_RTOL / atol 1e-4 * max|want|)."""
    if got.dtype != torch.float32:
        raise AssertionError(f"{what}: dtype {got.dtype}")
    return max_err(got, want, BF16_RTOL,
                   1e-4 * float(want.abs().max()), what)


def dgn_bf16_check(B, W, g_w, g_mm, seg, tag):
    """Phase 23's checks of K5/K6 on bf16 rows B (f32 W and g_mm; the
    wrappers round g_w) against their plain versions, in each
    instantiation: forward, raw backward with and without dW, autograd.
    Maxima and tie counts exact, dW at the f32 tolerances, the f32
    weighted sums and the bf16 dh within one bf16 ulp.  The autograd
    Functions' dB is held to K3's plain version of the kernel's own dh:
    a dh that rounds one ulp away from the plain version's may move a
    sum of several of them by more than one ulp of the sum.  Returns the
    largest error of each function, by name."""
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    from gsn_tpu_torch.ops.cuda import slab_weighted as b58
    rp, send = seg.recv_ptr, seg.send

    def dB_plain(dh):
        return k3.segment_sum_sorted_plain(dh, seg.send_ptr, seg.send_perm,
                                           torch.bfloat16)

    def bwd_err(got, want, what):
        err = bf16_check(got[0], want[0], f"{what} dh")
        if want[1] is not None:
            err = max(err, grad_check([got[1]], [want[1]], f"{what} dW"))
        return err

    errs = {}
    out_p = b58.weighted_gather_fwd_plain(B, W, rp, send)
    errs["weighted_gather_fwd"] = f32_ulp(
        b58.weighted_gather_fwd(B, W, rp, send), out_p,
        f"{tag} weighted_gather_fwd")
    errs["weighted_gather_bwd"] = max(bwd_err(
        b58.weighted_gather_bwd(B, W, g_w, rp, send, dw),
        b58.weighted_gather_bwd_plain(B, W, g_w, rp, send, dw),
        f"{tag} weighted_gather_bwd[dW={dw}]") for dw in (False, True))
    dh_w, _ = b58.weighted_gather_bwd(B, W, g_w, rp, send)
    _, dW_p = b58.weighted_gather_bwd_plain(B, W, g_w, rp, send, True)
    got = fn_grads(lambda b, w: (b58.weighted_gather(b, w, seg),), [B, W],
                   [g_w])
    errs["weighted_gather_bwd"] = max(
        errs["weighted_gather_bwd"],
        bwd_err(got, (dB_plain(dh_w), dW_p), f"{tag} WeightedGather"))

    mm, cnt = b6.segment_minmax_fwd(B, rp, send)
    mm_p, cnt_p = b6.segment_minmax_fwd_plain(B, rp, send)
    exact(mm, mm_p, f"{tag} segment_minmax_fwd")
    exact(cnt, cnt_p, f"{tag} segment_minmax_fwd tie counts")
    errs["segment_minmax_fwd"] = 0.0
    dh_mm = b6.segment_minmax_bwd(B, mm, cnt, g_mm, rp, send)
    got = fn_grads(lambda b: (b6.segment_minmax(b, seg),), [B], [g_mm])
    errs["segment_minmax_bwd"] = max(
        bf16_check(dh_mm, b6.minmax_dh_plain(B, mm_p, cnt_p, g_mm, rp, send),
                   f"{tag} segment_minmax_bwd"),
        bf16_check(got[0], dB_plain(dh_mm), f"{tag} SegmentMinmax dB"))

    out, mm2, cnt2 = b58.dgn_fused_fwd(B, W, rp, send)
    exact(mm2, mm_p, f"{tag} dgn_fused_fwd mm")
    exact(cnt2, cnt_p, f"{tag} dgn_fused_fwd tie counts")
    errs["dgn_fused_fwd"] = f32_ulp(out, out_p, f"{tag} dgn_fused_fwd")
    errs["dgn_fused_bwd"] = max(bwd_err(
        b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, rp, send, dw),
        b58.dgn_fused_bwd_plain(B, W, g_w, mm_p, cnt_p, g_mm, rp, send, dw),
        f"{tag} dgn_fused_bwd[dW={dw}]") for dw in (False, True))
    dh_f, _ = b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, rp, send)
    got = fn_grads(lambda b, w: b58.dgn_fused(b, w, seg), [B, W],
                   [g_w, g_mm])
    errs["dgn_fused_bwd"] = max(
        errs["dgn_fused_bwd"],
        bwd_err(got, (dB_plain(dh_f), dW_p), f"{tag} DGNFused"))
    return errs


def dgn_stress_bf16(dev):
    """Phase 23's stress shapes: phase 8's edge set (empty rows, a
    100-edge hub row) at d in {33, 64, 70, 130} and K in {1, 5, 16}, on
    bf16 rows of a few halves (maxima tie); returns the cases checked."""
    seg, n = dgn_stress_segments(dev)
    e = seg.send.numel()
    cases = 0
    for d in (33, 64, 70, 130):
        gen = torch.Generator(device=dev).manual_seed(d + 1)
        B = (torch.relu(torch.randint(-3, 4, (n, d), device=dev,
                                      generator=gen).float()) * 0.5
             ).bfloat16()
        g_mm = torch.randn(n, 2 * d, device=dev, generator=gen)
        for K in (1, 5, 16):
            W = torch.rand(e, K, device=dev, generator=gen)
            g_w = torch.randn(n, K * d, device=dev, generator=gen)
            dgn_bf16_check(B, W, g_w, g_mm, seg, f"bf16 stress d={d} K={K}")
            cases += 1
    torch.cuda.synchronize()
    return cases


def dgn_bf16_phases(dev, card, timed, dgn):
    """Phases 23-25 (see module docstring); ``dgn`` is the DGN path's
    (graphs, batch on the card).  Returns K5/K6's bf16 rows."""
    from gsn_tpu_torch.graphs.batching import iterate_batches
    from gsn_tpu_torch.nn.dgn import (DGNConfig, DGNNet, build_dgn_model,
                                      compute_avg_d)
    from gsn_tpu_torch.train.loop import Trainer
    from gsn_tpu_torch.train.metrics import LOSSES

    # ---- phase 23: K5/K6 on bf16 rows against the plain versions ----------
    graphs, data = dgn
    N, e_real = data.num_node_slots, data.num_real_edges
    d, K = DGN_D, DGN_K
    seg, W, B, g_w, g_mm = dgn_operands(dev, data)
    rp, send = seg.recv_ptr, seg.send
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    B, g_w_b = B.bfloat16(), g_w.bfloat16()
    errs = dgn_bf16_check(B, W, g_w, g_mm, seg, "bf16")
    log(f"[dgn-bf16] K5/K6 on bf16 rows agree with their plain versions "
        f"(maxima and tie counts exact): {errs}")
    log(f"[dgn-bf16] stress shapes (empty rows, a 100-edge hub row): "
        f"{dgn_stress_bf16(dev)} width/K cases agree with the plain "
        f"versions, maxima and tie counts exact")
    log(dgn_ptxas_line(d, K, "bf16"))

    # bounds as phase 8's, with B, g_w and dh in 2 bytes; W, out, mm,
    # cnt and g_mm stay 4
    walk = 2 * n_send * d + 4 * (N + 1 + e_real)
    kd, mm_w = K * d, 2 * d
    costs = {
        "weighted_gather_fwd": (walk + 4 * (e_real * K + N * kd),
                                2 * K * d * e_real),
        "weighted_gather_bwd": (4 * (e_real * K + N + 1)
                                + 2 * (n_recv * kd + e_real * d),
                                2 * K * d * e_real),
        "segment_minmax_fwd": (walk + 4 * 2 * N * mm_w, 2 * d * e_real),
        "segment_minmax_bwd": (walk + 4 * 3 * n_recv * mm_w
                               + 2 * e_real * d, 4 * d * e_real),
        "dgn_fused_fwd": (walk + 4 * (e_real * K + N * kd + 2 * N * mm_w),
                          (2 * K + 2) * d * e_real),
        "dgn_fused_bwd": (walk + 4 * (e_real * K + 3 * n_recv * mm_w)
                          + 2 * (n_recv * kd + e_real * d),
                          (2 * K + 4) * d * e_real),
    }
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    mm, cnt = b6.segment_minmax_fwd_plain(B, rp, send)
    # g_w already in bf16, so the timed backward calls do not round it
    calls = dgn_kernel_calls(B, W, g_w_b, mm, cnt, g_mm, seg)
    send_r = send[:e_real].long()
    hc = torch.cat([B[send_r], -B[send_r]], dim=1)
    recv = torch.repeat_interleave(torch.arange(N, device=dev), rp.diff())
    idx = recv[:, None].expand_as(hc)
    zeros_2d = torch.zeros(N, 2 * d, dtype=torch.bfloat16, device=dev)

    def scatter_max():
        return zeros_2d.scatter_reduce(0, idx, hc, "amax",
                                       include_self=False)

    # the maxima are exact in bf16: the library call gives the same
    # values (without the tie counts)
    exact(scatter_max().float(), mm, "library scatter max[bf16]")
    library = {"segment_minmax_fwd": scatter_max}
    replaces = {
        "weighted_gather_fwd": "gsn_tpu/ops/pallas/slab_weighted.py:76",
        "weighted_gather_bwd": "gsn_tpu/ops/pallas/slab_weighted.py:102",
        "segment_minmax_fwd": "gsn_tpu/ops/pallas/slab_minmax.py:119",
        "segment_minmax_bwd": "gsn_tpu/ops/pallas/slab_minmax.py:140",
        "dgn_fused_fwd": "gsn_tpu/ops/pallas/slab_weighted.py:294",
        "dgn_fused_bwd": "gsn_tpu/ops/pallas/slab_weighted.py:315",
    }
    rows = {}
    for name, (kernel, plain) in calls.items():
        t_b, by = bound(*costs[name])
        rows[f"{name}[bf16]"] = dict(
            source="gsn_tpu_torch/csrc/dgn_aggregate.cu",
            replaces=replaces[name], max_abs_err=errs[name], bound_ms=t_b,
            bound_by=by, **timed(kernel, plain, library.get(name)))
    torch.cuda.synchronize()

    # ---- phase 24: small bf16 DGN models, card vs CPU, each branch --------
    avg_d = compute_avg_d(graphs)
    small = next(iterate_batches(graphs[:64], 64, y_shape=(),
                                 y_dtype=np.float32))
    branch_fwd = {"fused": "dgn_fused_fwd", "weighted": "weighted_gather_fwd",
                  "minmax": "segment_minmax_fwd"}
    for branch, aggs in DGN_BRANCHES.items():
        cfg = DGNConfig(hidden_dim=d, out_dim=d, num_layers=2,
                        aggregators=aggs, avg_d=avg_d, dropout=0.0,
                        compute_dtype="bfloat16")
        bf16_card_vs_cpu(build_dgn_model(cfg,
                                         torch.Generator().manual_seed(2)),
                         small, LOSSES["BCEWithLogitsLoss"],
                         f"DGN {branch}", {branch_fwd[branch]: "bf16"},
                         cfg.num_layers)

    # ---- phase 25: the dgn-bf16 path (bench_dgn in bf16) ------------------
    cfg, tcfg = dgn_main_config(graphs)
    L = cfg.num_layers
    # K3: the node sums (f32) and the readout (f32 rows), and each layer's
    # dB (bf16 -> bf16); K4: the readout's backward (f32)
    modes = bf16_path(card, (graphs, data, cfg, tcfg), {
        "dgn_fused_fwd": L, "dgn_fused_bwd": L, "segment_sum_sorted": L + 2,
        "segment_broadcast": 1}, {
        "dgn_fused_fwd": {"bf16": L}, "dgn_fused_bwd": {"bf16": L},
        "segment_sum_sorted": {"f32->f32": 2, "bf16->bf16": L},
        "segment_broadcast": {"f32": 1}}, "dgn-bf16", model=DGNNet)
    for name in ("dgn_fused_fwd", "dgn_fused_bwd"):
        rows[f"{name}[bf16]"].update(launches=modes[name]["bf16"],
                                     path="dgn-bf16")
    # the weighted-only and minmax-only branches in bf16
    counters = kernel_counters()
    for branch in ("weighted", "minmax"):
        cfg_b = dataclasses.replace(cfg, aggregators=DGN_BRANCHES[branch],
                                    compute_dtype="bfloat16")
        tr = Trainer(cfg_b, tcfg, graphs, model=DGNNet(cfg_b))
        fwd = branch_fwd[branch]
        bwd = fwd.replace("_fwd", "_bwd")
        b_state, b_losses, b_s, b_launches, b_modes = train_steps(
            tr, tr.init_state(seed=0), data, BRANCH_STEPS, counters)
        expect_launches(b_launches, {fwd: L, bwd: L,
                                     "segment_sum_sorted": L + 2,
                                     "segment_broadcast": 1},
                        BRANCH_STEPS, f"DGN-bf16 {branch} path", b_modes,
                        {fwd: {"bf16": L}, bwd: {"bf16": L}})
        for name in (fwd, bwd):
            rows[f"{name}[bf16]"].update(launches=b_launches[name],
                                         path=f"dgn-bf16-{branch}")
        log(f"[dgn-bf16] {branch} path: losses {b_losses}, launches "
            f"{b_launches}, median step "
            f"{statistics.median(b_s[1:]) * 1e3:.3f} ms")
    return rows



def bf16_phases(dev, card, timed, zinc, molhiv):
    """Phases 18-22 (see module docstring); ``zinc`` and ``molhiv`` are
    the paths' (graphs, batch on the card, GSNConfig, TrainerConfig).
    Returns the bf16 modes' kernel rows, with their launches on the bf16
    paths."""
    from gsn_tpu_torch.train.metrics import LOSSES
    rows = bf16_zinc_kernels(dev, timed, zinc[1])
    rows.update(bf16_molhiv_kernels(dev, timed, molhiv[1]))

    # ---- phase 20: small bf16 models, card vs CPU ---------------------------
    zcfg = dataclasses.replace(zinc[2], compute_dtype="bfloat16")
    bf16_small_model(zcfg, zinc[0][:64], 64, LOSSES["L1Loss"], 7, "zinc")
    mcfg = dataclasses.replace(
        molhiv[2], num_layers=2, d_out=32, d_h=64, d_out_id_embedding=32,
        dropout_features=0.0, compute_dtype="bfloat16")
    bf16_small_model(mcfg, molhiv[0][:60], 64, LOSSES["BCEWithLogitsLoss"],
                     8, "GNN_OGB")

    # ---- phase 21: the zinc path in bf16 ------------------------------------
    L = zinc[2].num_layers
    modes = bf16_path(card, zinc, {
        "edge_message_fwd": L, "edge_message_bwd_recv": L,
        "segment_sum_sorted": 2 * L + 1, "segment_broadcast": L + 1}, {
        "edge_message_fwd": {"bf16": L}, "edge_message_bwd_recv": {"bf16": L},
        "segment_sum_sorted": {"bf16->bf16": L, "bf16->f32": L + 1},
        "segment_broadcast": {"bf16": L + 1}}, "zinc-bf16")
    for name, kernel, mode in (
            ("edge_message_fwd[bf16]", "edge_message_fwd", "bf16"),
            ("edge_message_bwd_recv[bf16]", "edge_message_bwd_recv", "bf16"),
            ("segment_sum_sorted[bf16->bf16]", "segment_sum_sorted",
             "bf16->bf16"),
            ("segment_sum_sorted[bf16->f32]", "segment_sum_sorted",
             "bf16->f32"),
            ("segment_broadcast[bf16 d=128]", "segment_broadcast", "bf16")):
        rows[name].update(launches=modes[kernel][mode], path="zinc-bf16")

    # ---- phase 22: the molhiv path in bf16 ----------------------------------
    L = molhiv[2].num_layers
    # K3: each layer's dB and B4 backward (bf16 -> bf16), the L-1 virtual
    # node pools and the readout (bf16 -> f32); K4: each B4 forward and
    # each pool's backward
    modes = bf16_path(card, molhiv, {
        "edge_message_fwd": L, "edge_message_bwd_recv": L,
        "graph_broadcast": L, "segment_broadcast": 2 * L,
        "segment_sum_sorted": 3 * L}, {
        "edge_message_fwd": {"bf16": L}, "edge_message_bwd_recv": {"bf16": L},
        "graph_broadcast": {"bf16": L}, "segment_broadcast": {"bf16": 2 * L},
        "segment_sum_sorted": {"bf16->bf16": 2 * L, "bf16->f32": L}},
        "molhiv-bf16")
    for name, kernel in (
            ("edge_message_fwd[bf16 ogb]", "edge_message_fwd"),
            ("edge_message_bwd_recv[bf16 ogb]", "edge_message_bwd_recv"),
            ("graph_broadcast[bf16]", "graph_broadcast"),
            ("segment_broadcast[bf16 d=300]", "segment_broadcast")):
        rows[name].update(launches=modes[kernel]["bf16"], path="molhiv-bf16")
    return rows


def fused_bn_phases(dev, card, timed, zinc):
    """Phases 26-28 (see module docstring); ``zinc`` is the zinc path's
    (graphs, batch on the card, GSNConfig, TrainerConfig).  Returns the
    rows of K1/K2's bf16 id_sq mode and K3 f32 -> bf16."""
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.train.metrics import LOSSES

    # ---- phase 26: K1/K2 id_sq and K3 f32 -> bf16 at d=128 ----------------
    graphs, data, cfg, tcfg = zinc
    N, E = data.num_node_slots, data.num_edge_slots
    e_real = data.num_real_edges
    seg = edge_segments(data)
    rp, send, sp, perm = seg.recv_ptr, seg.send, seg.send_ptr, seg.send_perm
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    n_dst = sp.numel() - 1
    gen = torch.Generator(device=dev).manual_seed(9)
    src = "gsn_tpu_torch/csrc/"
    bf = torch.bfloat16
    rows, errs, extra = {}, {}, {}
    for dtype in (torch.float32, bf):
        dn = "f32" if dtype == torch.float32 else "bf16"
        t = 4 if dtype == torch.float32 else 2

        def rnd(*shape):
            return torch.randn(*shape, device=dev, generator=gen).to(dtype)

        A, B, Pe = rnd(N, D), rnd(N, D), rnd(E, D)
        b1 = torch.randn(D, device=dev, generator=gen)
        g = torch.randn(N, 2 * D, device=dev, generator=gen)
        err_f = err_b = 0.0
        for a, pe in ((A, Pe), (None, None)):
            hs = k12.edge_message_fwd(a, B, pe, b1, rp, send, "id_sq")
            err_f = max(err_f, max_err(
                hs, k12.edge_message_fwd_plain(a, B, pe, b1, rp, send,
                                               "id_sq"),
                FWD_RTOL, FWD_ATOL, f"edge_message_fwd[id_sq {dn}]"))
            dH, dA = k12.edge_message_bwd_recv(a, B, pe, b1, g, rp, send,
                                               "id_sq", E)
            dH_p, dA_p = k12.edge_message_bwd_recv_plain(
                a, B, pe, b1, g, rp, send, "id_sq", E)
            err_b = max(err_b, max_err(dH, dH_p, FWD_RTOL, FWD_ATOL,
                                       f"edge_message_bwd_recv[id_sq {dn}] "
                                       f"dH"))
            if a is not None:
                err_b = max(err_b, bf16_check(dA, dA_p, "id_sq dA")
                            if dtype == bf else grad_check(
                                [dA], [dA_p], "id_sq dA"))
            # the autograd Function: dA, dB (K3 f32 -> data dtype), dPe,
            # db1 against the plain backward
            ins = [x for x in (a, B, pe, b1) if x is not None]
            leaves = [x.clone().requires_grad_(True) for x in ins]
            it = iter(leaves)
            args = [next(it) if x is not None else None
                    for x in (a, B, pe, b1)]
            got = torch.autograd.grad((k12.edge_message_aggregate(
                *args, seg, "id_sq") * g).sum(), leaves)
            want = ([dA_p] if a is not None else []) + [
                k3.segment_sum_sorted_plain(dH_p, sp, perm, dtype)] + (
                [dH_p.to(dtype)] if pe is not None else [])
            for x, w in zip(got[:-1], want):
                err_b = max(err_b, bf16_check(x, w, f"EdgeMessageAggregate"
                                                    f"[id_sq {dn}]")
                            if dtype == bf else grad_check(
                                [x], [w], f"EdgeMessageAggregate[id_sq]"))
            err_b = max(err_b, grad_check([got[-1]], [dH_p.sum(0)],
                                          f"EdgeMessageAggregate[id_sq {dn}]"
                                          f" db1"))
        errs[dn] = (err_f, err_b)
        # read A, B, Pe, b1, recv_ptr, send; write the f32 [N, 2d] moments
        fwd_b = bound(t * ((n_recv + n_send) * D + e_real * D)
                      + 4 * (D + N + 1 + e_real + N * 2 * D),
                      7 * e_real * D)
        # read A, B, Pe, b1, g (f32, 2d), recv_ptr, send; write dH (f32,
        # every slot) and dA (data dtype)
        bwd_b = bound(t * ((n_recv + n_send + N) * D + e_real * D)
                      + 4 * (2 * n_recv * D + E * D + D + N + 1 + e_real),
                      8 * e_real * D)
        fwd = timed(lambda: k12.edge_message_fwd(A, B, Pe, b1, rp, send,
                                                 "id_sq"),
                    lambda: k12.edge_message_fwd_plain(A, B, Pe, b1, rp,
                                                       send, "id_sq"))
        bwd = timed(lambda: k12.edge_message_bwd_recv(A, B, Pe, b1, g, rp,
                                                      send, "id_sq", E),
                    lambda: k12.edge_message_bwd_recv_plain(
                        A, B, Pe, b1, g, rp, send, "id_sq", E))
        for name, row, (t_b, by), err in (
                (f"edge_message_fwd[id_sq {dn}]", fwd, fwd_b, err_f),
                (f"edge_message_bwd_recv[id_sq {dn}]", bwd, bwd_b, err_b)):
            row.update(max_abs_err=err, bound_ms=t_b, bound_by=by)
            if dtype == bf:
                rows[name] = dict(
                    source=src + "edge_message.cu",
                    replaces="gsn_tpu/ops/pallas/slab_message.py:"
                             + ("214" if "fwd" in name else "240"), **row)
            else:
                extra[name] = row
    # K3 f32 -> bf16: the id_sq pass's dB (an f32 dH into bf16 B rows)
    dH = torch.randn(E, D, device=dev, generator=gen)
    err = bf16_check(k3.segment_sum_sorted(dH, sp, perm, bf),
                     k3.segment_sum_sorted_plain(dH, sp, perm, bf),
                     "segment_sum_sorted[f32->bf16]")
    t_b, by = bound(4 * e_real * D + 2 * n_dst * D
                    + 4 * (n_dst + 1 + e_real), e_real * D)
    rows["segment_sum_sorted[f32->bf16]"] = dict(
        source=src + "segment_sum.cu",
        replaces="gsn_tpu/ops/pallas/slab_combine.py:77",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k3.segment_sum_sorted(dH, sp, perm, bf),
                lambda: k3.segment_sum_sorted_plain(dH, sp, perm, bf)))
    for name, row in extra.items():   # f32 id_sq: no path launches it
        log_row("id_sq", name, row)
    log(f"[id_sq] at d={D}: K1/K2 id_sq agree with their plain versions "
        f"(moments and dH at the f32 tolerances; dA, dB, dPe in the data "
        f"dtype), max abs err (fwd, bwd) by data dtype {errs}; K3 "
        f"f32->bf16 within one bf16 ulp")
    torch.cuda.synchronize()

    # ---- phase 27: a small zinc model, bf16 + bn_mlp, card vs CPU ---------
    L = cfg.num_layers
    bf16_small_model(dataclasses.replace(cfg, compute_dtype="bfloat16",
                                         bn_mlp=True),
                     graphs[:64], 64, LOSSES["L1Loss"], 10, "zinc bn_mlp",
                     {"edge_message_fwd": "bf16 id_sq",
                      "edge_message_bwd_recv": "bf16 id_sq"}, f32_gate=True)

    # ---- phase 28: the zinc-bf16-bnmlp path -------------------------------
    # K1/K2: each layer's id_sq pass and its relu pass; K3: each pass's
    # dB (id_sq: f32 -> bf16, relu: bf16 -> bf16) and the L + 1 pools
    modes = bf16_path(card, zinc, {
        "edge_message_fwd": 2 * L, "edge_message_bwd_recv": 2 * L,
        "segment_sum_sorted": 3 * L + 1, "segment_broadcast": L + 1}, {
        "edge_message_fwd": {"bf16": L, "bf16 id_sq": L},
        "edge_message_bwd_recv": {"bf16": L, "bf16 id_sq": L},
        "segment_sum_sorted": {"bf16->bf16": L, "f32->bf16": L,
                               "bf16->f32": L + 1},
        "segment_broadcast": {"bf16": L + 1}}, "zinc-bf16-bnmlp",
        over={"bn_mlp": True})
    for name, kernel, mode in (
            ("edge_message_fwd[id_sq bf16]", "edge_message_fwd",
             "bf16 id_sq"),
            ("edge_message_bwd_recv[id_sq bf16]", "edge_message_bwd_recv",
             "bf16 id_sq"),
            ("segment_sum_sorted[f32->bf16]", "segment_sum_sorted",
             "f32->bf16")):
        rows[name].update(launches=modes[kernel][mode],
                          path="zinc-bf16-bnmlp")
    return rows


LAUNCH_PROBE_SRC = r"""
// An empty kernel: the launch floor of a grid, for the smoke log.
#include <cuda_runtime.h>
__global__ void gsn_empty_kernel() {}
extern "C" int gsn_empty(int blocks, int threads, void* stream) {
  gsn_empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def start_launch_probe():
    """Start ``nvcc`` on the empty kernel that measures the launch floor
    (it builds beside the port's kernels, into ``build/``)."""
    from gsn_tpu_torch.ops.cuda import build
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, "launch_probe.cu")
    with open(src, "w") as f:
        f.write(LAUNCH_PROBE_SRC)
    so = os.path.join(build.BUILD_DIR, "liblaunch_probe.so")
    return so, subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_launch_probe(probe):
    """The probe's ``gsn_empty(blocks, threads, stream)``."""
    import ctypes
    so, proc = probe
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"nvcc failed for the launch probe:\n{out}")
    fn = ctypes.CDLL(so).gsn_empty
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_floor_ms(empty, cpm, blocks):
    """Device ms of an empty kernel on a grid of ``blocks`` blocks of 256
    threads."""
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = empty(blocks, 256, stream)
        if rc:
            raise AssertionError(f"empty kernel: CUDA error {rc}")

    return time_ms(call, cpm)[0]


def k3_blocks(form, n_seg, lanes=32):
    """K3's grid: a block a segment in the block form; in the warp form
    a group of ``lanes`` lanes a segment, in blocks of 256 threads."""
    return n_seg if form == "block" else -(-n_seg // (256 // lanes))


def k1_blocks(n_rows, lanes=32):
    """K1's grid (``csrc/edge_message.cu``: group_rows): groups of
    ``lanes`` lanes that walk 4, 2 or 1 rows, the most that leaves a
    warp's worth of groups (32) for each of the card's SMs, in blocks of
    256 threads."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rpg = 4
    while rpg > 1 and n_rows < rpg * sms * 32:
        rpg //= 2
    groups = -(-n_rows // rpg)
    return -(-groups // (256 // lanes))


# K2's grid is K1's: the same group_rows rule over the receiver rows
k2_blocks = k1_blocks


def zinc_cli_argv(root, *extra):
    """``scripts/zinc_10_runs.py --budget 500K`` (seed 0) on the synthetic
    ZINC set under ``root``, 2 epochs with an evaluation each, JSONL
    logging, on the card."""
    argv = ["--seed", "0", "--onesplit", "True", "--dataset", "chemical",
            "--dataset_name", "ZINC", "--root_folder", root,
            "--cache_folder", os.path.join(root, "cache"),
            "--id_type", "cycle_graph", "--induced", "False", "--k", "8",
            "--id_scope", "global", "--id_encoding", "one_hot_unique",
            "--id_embedding", "one_hot_encoder",
            "--input_node_encoder", "one_hot_encoder",
            "--edge_encoder", "one_hot_encoder",
            "--model_name", "GSN_edge_sparse", "--msg_kind", "general",
            "--num_layers", str(ZINC_CLI_LAYERS), "--d_out", str(CLI_D),
            "--dropout_features", "0", "--final_projection", "False",
            "--jk_mlp", "True", "--readout", "sum", "--batch_size", "128",
            "--num_epochs", "2", "--eval_frequency", "1", "--lr", "1e-3",
            "--scheduler", "ReduceLROnPlateau", "--decay_rate", "0.5",
            "--patience", "5", "--min_lr", "1e-5", "--regression", "True",
            "--loss_fn", "L1Loss", "--prediction_fn", "L1Loss",
            "--mode", "train", "--wandb", "False"]
    return argv + list(extra)


def zinc_cli_f32_launches():
    """Phase 30's launches (``cli_path``'s per train step, per eval step,
    and K3's forms a train and an eval step): in f32 each layer's
    per-edge messages are summed at the receivers (K3, backward K4) and
    so is the one pool (K3, backward K4); each layer's two per-edge
    gathers (``A[recv]``, ``B[send]``) have K3 over the receivers and
    over the senders as their backward.  The message sums and the
    gathers' backward take K3's warp form, the pool its block form."""
    L = ZINC_CLI_LAYERS
    return ({"segment_sum_sorted": {"f32->f32": 3 * L + 1},
             "segment_broadcast": {"f32": L + 1}},
            {"segment_sum_sorted": {"f32->f32": L + 1}},
            ({"warp": 3 * L, "block": 1}, {"warp": L, "block": 1}))


def zinc_cli_ep_launches():
    """``zinc_cli_f32_launches`` under ep: the f32 bn_mlp messages take
    the fused-BN route, as the reference's do
    (gsn_tpu/nn/filters.py:355-363): K1/K2 in f32 and in f32 id_sq a
    layer, K3 the dB of both passes and the pool, K4 the pool's
    backward; an eval step K1 and the pool."""
    L = ZINC_CLI_LAYERS
    return ({"edge_message_fwd": {"f32": L, "f32 id_sq": L},
             "edge_message_bwd_recv": {"f32": L, "f32 id_sq": L},
             "segment_sum_sorted": {"f32->f32": 2 * L + 1},
             "segment_broadcast": {"f32": 1}},
            {"edge_message_fwd": {"f32": L},
             "segment_sum_sorted": {"f32->f32": 1}},
            ({"warp": 2 * L, "block": 1}, {"block": 1}))


def zinc_cli_trainer(args, dev):
    """The trainer of a zinc-cli run's parsed ``args`` (its data written
    by ``write_zinc_dataset``): (a function making a fresh ``Trainer`` of
    its configuration, its train graphs, its first train batch in a
    fixed order on ``dev``)."""
    from gsn_tpu_torch import cli
    graphs, cfg = cli.prepare(args)
    train = cli.fold_splits(args, graphs, -1)[0]

    def make():
        return cli.Trainer(cfg, cli.trainer_config(args), train)

    return make, train, make()._eval_batches(train, 1)[0].to(dev)


def run_cli(argv):
    from gsn_tpu_torch import cli
    return cli.main(vars(cli.build_parser().parse_args(argv)))


def read_log(args, fold=-1):
    """(run directory, records of its log.jsonl) of a CLI run."""
    from gsn_tpu_torch import cli
    run_dir = cli.run_dir(args, fold)
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        return run_dir, [json.loads(line) for line in f]


def k12_timed(timed, data, d, dtype, act, gen):
    """K1 and K2 in ``act`` mode on ``dtype`` data at width ``d`` over the
    batch's edges, against their plain versions; their (fwd, bwd) rows
    with bounds (rows the functions must touch, as phase 3's).  K2's row
    also carries ``pad_fill_ms``: the wrapper's zero fill of dH, every
    slot (a PyTorch fill launched before the kernel, part of ``ms``: which
    slots are padding is known only on the device), timed alone."""
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    N, E, e_real = data.num_node_slots, data.num_edge_slots, \
        data.num_real_edges
    seg = edge_segments(data)
    rp, send = seg.recv_ptr, seg.send
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    t = 2 if dtype == torch.bfloat16 else 4
    tag = f"{dtype_tag(dtype)} {act} d={d}"

    def rnd(*shape):
        return torch.randn(*shape, device=data.x.device,
                           generator=gen).to(dtype)

    A, B, Pe = rnd(N, d), rnd(N, d), rnd(E, d)
    b1 = torch.randn(d, device=data.x.device, generator=gen)
    g = torch.randn(N, 2 * d if act == "id_sq" else d,
                    device=data.x.device, generator=gen)
    if act != "id_sq":
        g = g.to(dtype)

    def close(got, want, what):
        if got.dtype == torch.bfloat16:
            return bf16_check(got, want, what)
        return max_err(got, want, FWD_RTOL, FWD_ATOL, what)

    err_f = close(k12.edge_message_fwd(A, B, Pe, b1, rp, send, act),
                  k12.edge_message_fwd_plain(A, B, Pe, b1, rp, send, act),
                  f"edge_message_fwd[{tag}]")
    dH, dA = k12.edge_message_bwd_recv(A, B, Pe, b1, g, rp, send, act, E)
    dH_p, dA_p = k12.edge_message_bwd_recv_plain(A, B, Pe, b1, g, rp, send,
                                                 act, E)
    if dH.dtype == torch.bfloat16:
        exact(dH, dH_p, f"edge_message_bwd_recv[{tag}] dH")
        err_b = 0.0
    else:
        err_b = max_err(dH, dH_p, FWD_RTOL, FWD_ATOL,
                        f"edge_message_bwd_recv[{tag}] dH")
    err_b = max(err_b, bf16_check(dA, dA_p, f"[{tag}] dA")
                if dA.dtype == torch.bfloat16
                else grad_check([dA], [dA_p], f"[{tag}] dA"))
    idx = 4 * (d + N + 1 + e_real)
    if act == "id_sq":
        fwd_b = bound(t * ((n_recv + n_send) * d + e_real * d) + idx
                      + 4 * N * 2 * d, 7 * e_real * d)
        bwd_b = bound(t * ((n_recv + n_send + N) * d + e_real * d) + idx
                      + 4 * (2 * n_recv * d + E * d), 8 * e_real * d)
    else:
        fwd_b = bound(t * ((n_recv + n_send + N) * d + e_real * d) + idx,
                      5 * e_real * d)
        bwd_b = bound(t * ((2 * n_recv + n_send + N) * d + e_real * d
                           + E * d) + idx, 5 * e_real * d)
    fwd = timed(lambda: k12.edge_message_fwd(A, B, Pe, b1, rp, send, act),
                lambda: k12.edge_message_fwd_plain(A, B, Pe, b1, rp, send,
                                                   act))
    bwd = timed(lambda: k12.edge_message_bwd_recv(A, B, Pe, b1, g, rp, send,
                                                  act, E),
                lambda: k12.edge_message_bwd_recv_plain(A, B, Pe, b1, g, rp,
                                                        send, act, E),
                also={"pad_fill_ms": lambda: dH.zero_()})
    src = "gsn_tpu_torch/csrc/edge_message.cu"
    out = []
    for row, (t_b, by), err, line in ((fwd, fwd_b, err_f, "214"),
                                      (bwd, bwd_b, err_b, "240")):
        out.append(dict(source=src,
                        replaces=f"gsn_tpu/ops/pallas/slab_message.py:{line}",
                        max_abs_err=err, bound_ms=t_b, bound_by=by, **row))
    return out


def dtype_tag(dtype):
    return "bf16" if dtype == torch.bfloat16 else "f32"


def zinc_cli_kernels(dev, timed, data, d, empty, cpm, main_pool):
    """Phase 30's kernel checks at the zinc-cli path's shapes (one train
    batch of 128 graphs at the trainer's caps, width d): K1/K2 f32 relu
    (log lines: no zinc-cli path launches them), K1/K2 bf16 relu and
    id_sq, K3 (f32: the per-edge messages' sum at their receivers, warp
    form, and the pool, block form; bf16 -> f32: the pool; each beside
    ``index_add`` and ``segment_reduce``; dB bf16 -> bf16 and f32 ->
    bf16) and K4 (f32: the backward of both; bf16: the pool's), each
    against its plain version and timed; the block form called twice
    on the same rows must give the same bits.  Each K1, K2 and K3 row
    carries ``floor_ms``, an empty kernel on its grid (``blocks``); the
    launch floor is also logged on the grids of the zinc path's pools
    (``main_pool``: its graphs and node slots).  Returns the rows by
    name."""
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_pool as k4
    gen = torch.Generator(device=dev).manual_seed(11)
    N, E, G = data.num_node_slots, data.num_edge_slots, data.num_graph_slots
    e_real, gp = data.num_real_edges, data.graph_ptr
    n_real = int(data.node_mask.sum())
    log(f"[zinc-cli] kernel shapes: d={d}, nodes {n_real}/{N}, edges "
        f"{e_real}/{E}, graphs {int(data.graph_mask.sum())}/{G}")
    rows = {}
    k1_floor = launch_floor_ms(empty, cpm, k1_blocks(N))
    k2_floor = launch_floor_ms(empty, cpm, k2_blocks(N))
    # f32: the ep route of phase 41; bf16: zinc-cli-bf16
    bf = torch.bfloat16
    for dt, act, mode in ((torch.float32, "relu", "f32"),
                          (torch.float32, "id_sq", "id_sq f32"),
                          (bf, "relu", "bf16"), (bf, "id_sq", "id_sq bf16")):
        fwd, bwd = k12_timed(timed, data, d, dt, act, gen)
        rows[f"edge_message_fwd[{mode} d={d}]"] = dict(
            fwd, floor_ms=k1_floor, blocks=k1_blocks(N))
        rows[f"edge_message_bwd_recv[{mode} d={d}]"] = dict(
            bwd, floor_ms=k2_floor, blocks=k2_blocks(N))
    src = "gsn_tpu_torch/csrc/"
    seg = edge_segments(data)
    sp, perm = seg.send_ptr, seg.send_perm
    n_dst = sp.numel() - 1
    rp = seg.recv_ptr
    zeros_gd = torch.zeros(G, d, device=dev)
    zeros_nd = torch.zeros(N, d, device=dev)
    batch_l = data.batch[:n_real].long()
    recv_l = data.edge_index[data.select, :e_real].long()
    n_recv = int((rp.diff() > 0).sum())

    def pool_row(x, ptr, n_in, idx, zeros, t_in, what):
        """K3 from ``x``'s first ``n_in`` rows into the segments ``ptr``,
        in the form ``segment_sum_form`` picks, against its plain version;
        timed beside ``index_add`` (f32 only: on bf16 rows it sums in
        bf16) and ``segment_reduce`` (bf16 out from bf16 rows, so only a
        time beside the row), with the launch floor of its grid."""
        n_seg = ptr.numel() - 1
        form = k3.segment_sum_form(n_seg, x.shape[0])
        got = k3.segment_sum_sorted(x, ptr)
        err = max_err(got, k3.segment_sum_sorted_plain(x, ptr), FWD_RTOL,
                      FWD_ATOL, f"segment_sum_sorted[{what}]")
        if form == "block" and not torch.equal(
                got, k3.segment_sum_sorted(x, ptr)):
            raise AssertionError(f"segment_sum_sorted[{what}]: the block "
                                 f"form gave other bits on a second call")
        t_b, by = bound(t_in * n_in * d + 4 * (n_seg * d + n_seg + 1),
                        n_in * d)
        ptr_l = ptr.long()
        blocks = k3_blocks(form, n_seg)
        return dict(source=src + "segment_sum.cu",
                    replaces="gsn_tpu/ops/pallas/slab_pool.py:84",
                    form=form, max_abs_err=err, bound_ms=t_b, bound_by=by,
                    floor_ms=launch_floor_ms(empty, cpm, blocks),
                    blocks=blocks,
                    **timed(lambda: k3.segment_sum_sorted(x, ptr),
                            lambda: k3.segment_sum_sorted_plain(x, ptr),
                            (lambda: torch.index_add(zeros, 0, idx, x[:n_in]))
                            if x.dtype == torch.float32 else None,
                            also={"segment_reduce_ms": lambda: (
                                torch.segment_reduce(x[:n_in], "sum",
                                                     offsets=ptr_l))}))

    # f32 (zinc-cli): K3 sums each layer's per-edge messages at their
    # receivers (warp form) and pools the last layer (block form); K4 is
    # the backward of both
    msgs = torch.randn(E, d, device=dev, generator=gen)
    rows[f"segment_sum_sorted[f32 d={d}]"] = pool_row(
        msgs, rp, e_real, recv_l, zeros_nd, 4, f"aggregate f32 d={d}")
    rows[f"segment_sum_sorted[f32 d={d}]"].update(
        replaces="gsn_tpu/ops/pallas/slab_combine.py:77")
    x = torch.randn(N, d, device=dev, generator=gen)
    rows[f"segment_sum_sorted[pool f32 d={d}]"] = pool_row(
        x, gp, n_real, batch_l, zeros_gd, 4, f"pool f32 d={d}")
    rows[f"segment_broadcast[f32 d={d}]"] = dict(
        source=src + "segment_broadcast.cu",
        replaces="gsn_tpu/ops/pallas/slab_pool.py:90",
        **k4_timed_ptr(timed, torch.randn(N, d, device=dev, generator=gen),
                       rp, E, k4.segment_broadcast,
                       k4.segment_broadcast_plain))
    log_row("zinc-cli", f"segment_broadcast[pool backward f32 d={d}]",
            k4_timed(timed, data, torch.randn(G, d, device=dev,
                                              generator=gen),
                     k4.segment_broadcast, k4.segment_broadcast_plain))
    log(f"[zinc-cli] receivers with edges {n_recv} of {N}")
    # bf16 (zinc-cli-bf16): K3 and K4 pool only (the messages are fused)
    xb = torch.randn(N, d, device=dev, generator=gen).to(bf)
    rows[f"segment_sum_sorted[bf16->f32 d={d}]"] = pool_row(
        xb, gp, n_real, batch_l, zeros_gd, 2, f"pool bf16->f32 d={d}")
    rows[f"segment_broadcast[bf16 d={d}]"] = dict(
        source=src + "segment_broadcast.cu",
        replaces="gsn_tpu/ops/pallas/slab_pool.py:90",
        **k4_timed(timed, data, torch.randn(G, d, device=dev,
                                            generator=gen).to(bf),
                   k4.segment_broadcast, k4.segment_broadcast_plain))
    # the launch floor on the zinc path's pool grids (d=128, 1024 graphs
    # over its node slots: the f32 rows' lanes are a warp, the bf16 rows'
    # a half warp in the warp form)
    main_graphs = main_pool[0]
    for what, lanes in (("f32", 32), ("bf16 -> f32", 16)):
        form = k3.segment_sum_form(*main_pool)
        blocks = k3_blocks(form, main_graphs, lanes)
        log(f"[launch floor] zinc {what} pool (d={D}, G={main_graphs}, "
            f"{form} form): an empty kernel on its grid ({blocks} blocks "
            f"of 256 threads) {launch_floor_ms(empty, cpm, blocks)} ms")
    # K3 dB at this width: bf16 -> bf16 (relu pass) and f32 -> bf16 (id_sq)
    for src_dt, mode in ((bf, "bf16->bf16"), (torch.float32, "f32->bf16")):
        dH = torch.randn(E, d, device=dev, generator=gen).to(src_dt)
        err = bf16_check(k3.segment_sum_sorted(dH, sp, perm, bf),
                         k3.segment_sum_sorted_plain(dH, sp, perm, bf),
                         f"segment_sum_sorted[{mode} d={d}]")
        t_in = 2 if src_dt == bf else 4
        t_b, by = bound(t_in * e_real * d + 2 * n_dst * d
                        + 4 * (n_dst + 1 + e_real), e_real * d)
        form = k3.segment_sum_form(n_dst, perm.numel())
        blocks = k3_blocks(form, n_dst)
        rows[f"segment_sum_sorted[{mode} d={d}]"] = dict(
            source=src + "segment_sum.cu",
            replaces="gsn_tpu/ops/pallas/slab_combine.py:77", form=form,
            max_abs_err=err, bound_ms=t_b, bound_by=by,
            floor_ms=launch_floor_ms(empty, cpm, blocks), blocks=blocks,
            **timed(lambda: k3.segment_sum_sorted(dH, sp, perm, bf),
                    lambda: k3.segment_sum_sorted_plain(dH, sp, perm, bf)))
    torch.cuda.synchronize()
    return rows


def profile_epoch(trainer, state, graphs, epoch_s, tag):
    """One train epoch under ``torch.profiler``: the device's busy time
    and its share of the unprofiled epoch's wall time ``epoch_s``."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as exc:
        log(f"[profile {tag}] not measured ({exc})")
        return trainer.train_epoch(state, graphs)[0]
    t0 = time.perf_counter()
    state, _ = trainer.train_epoch(state, graphs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    try:
        prof.stop()
    except RuntimeError as exc:
        log(f"[profile {tag}] not measured ({exc})")
        return state
    events = device_events(prof)
    if not events:
        log(f"[profile {tag}] not measured (no device time recorded)")
        return state
    busy = sum(us for us, _ in events) / 1e6
    steps = trainer.epoch_stats["steps"]
    n_kernels = sum(e.count for _, e in events)
    log(f"[profile {tag}] one epoch ({steps} steps): device busy {busy:.4f} "
        f"s in {n_kernels} launches ({busy / steps * 1e3:.3f} ms, "
        f"{n_kernels / steps:.0f} launches a step); profiled wall "
        f"{wall:.4f} s; busy share {busy / epoch_s:.4f} of the unprofiled "
        f"epoch ({epoch_s:.4f} s), idle share {1 - busy / epoch_s:.4f}")
    events.sort(key=lambda ue: -ue[0])
    for us, e in events[:8]:
        log(f"[profile {tag}]   {us / steps:9.1f} us/step  "
            f"x{e.count / steps:5.1f}  {e.key[:90]}")
    return state


def cli_path(card, root, tag, per_train, per_eval, forms, *extra):
    """Phase 30's run of the CLI (``zinc_cli_argv`` + ``extra``):
    launch counters zeroed just before ``cli.main`` and read just after,
    exactly ``per_train`` a train step and ``per_eval`` an eval step (by
    kernel and mode) and ``forms`` (K3's launches by form, a train step
    and an eval step); finite histories, the lr at each evaluation, the
    run's files, its per-epoch times and peak memory.  Returns (args,
    history, launches by mode, K3's launches by form, the log
    records)."""
    from gsn_tpu_torch import cli
    from gsn_tpu_torch.ops.cuda import build
    argv = zinc_cli_argv(root, *extra)
    args = vars(cli.build_parser().parse_args(argv))
    counters = kernel_counters()
    # the path's own peak: above what earlier phases still hold
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        build.reset(fn)
    t0 = time.perf_counter()
    hist = run_cli(argv)[0]
    wall = time.perf_counter() - t0
    modes = {name: dict(fn.modes) for name, fn in counters.items()
             if fn.modes}
    k3_forms = dict(counters["segment_sum_sorted"].forms)
    run_dir, recs = read_log(args)
    evals = [r for r in recs if "train_loss" in r]
    for key, vals in hist.items():
        if len(vals) != args["num_epochs"] or not np.isfinite(vals).all():
            raise AssertionError(f"{tag}: history {key} = {vals}")
    ckpt = cli.checkpoint_path(args, -1)
    for path in (os.path.join(run_dir, "log.jsonl"),
                 os.path.join(run_dir, "params.json"), ckpt):
        if not os.path.exists(path):
            raise AssertionError(f"{tag}: {path} is missing")
    n_train = -(-ZINC_SIZES[0] // 128)
    n_eval = sum(-(-n // 128) for n in ZINC_SIZES)
    epochs = args["num_epochs"]
    expect_cli_launches(tag, {**modes, "K3 forms": k3_forms},
                        {**per_train, "K3 forms": forms[0]},
                        {**per_eval, "K3 forms": forms[1]},
                        n_train * epochs, n_eval * epochs)
    log(f"[{tag}] cli.main {wall:.3f} s: {epochs} epochs of {n_train} "
        f"train steps and {n_eval} eval steps; launches by mode {modes} "
        f"= a train step {per_train}, an eval step {per_eval}; K3 by form "
        f"{k3_forms} = a train and an eval step {forms}")
    log(f"[{tag}] watch: {recs[0]['watch_num_params']} parameters")
    for r in evals:
        log(f"[{tag}] epoch {r['step']}: train {r['train_loss']:.6f} test "
            f"{r['test_loss']:.6f} val {r['val_loss']:.6f} lr {r['lr']}; "
            f"epoch {r['epoch_s']:.4f} s ({r['steps']} steps, median step "
            f"{r['step_median_s'] * 1e3:.3f} ms, host batching "
            f"{r['host_batch_s'] / r['steps'] * 1e3:.3f} ms a step = "
            f"{r['host_batch_s'] / r['epoch_s']:.4f} of the epoch); "
            f"evaluation {r['eval_s']:.4f} s")
    log(f"[{tag}] files: {sorted(os.listdir(run_dir))}, checkpoint "
        f"{os.path.basename(ckpt)}; peak memory "
        f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.3f} GiB "
        f"above the {held / 2**30:.3f} GiB earlier phases hold ({card})")
    return args, hist, modes, k3_forms, evals


def cli_phases(dev, card, timed, cpm, empty, main_pool, root):
    """Phases 29-32 (see module docstring), their data written under
    ``root``; returns (the zinc-cli paths' kernel rows, phase 30's
    history)."""
    from gsn_tpu_torch import cli
    from gsn_tpu_torch.data.encoding import encode
    from gsn_tpu_torch.data.pipeline import prepare_dataset
    from gsn_tpu_torch.data.synthetic import write_sr16622, write_zinc_dataset

    # ---- phase 29: the data ----------------------------------------
    t0 = time.perf_counter()
    path = write_zinc_dataset(root, ZINC_SIZES, seed=0)
    wrote = time.perf_counter() - t0
    times, sets = [], []
    for _ in range(2):   # cold, then from the cache
        t0 = time.perf_counter()
        sets.append(prepare_dataset(
            path, "chemical", "ZINC", id_scope="global",
            id_type="cycle_graph", k=[8], root_folder=root,
            cache_root=os.path.join(root, "cache")))
        times.append(time.perf_counter() - t0)
    (cold, n_cls, sizes), (warm, _n, _s) = sets
    if len(cold) != sum(ZINC_SIZES) or any(
            not np.array_equal(a["identifiers"], b["identifiers"])
            for a, b in zip(cold, warm)):
        raise AssertionError("zinc-cli data: the cache disagrees")
    _g, _e, d_id, _ed, _dd = encode(warm, "one_hot_unique")
    log(f"[zinc-cli] data: {len(cold)} molecules ({ZINC_SIZES}) written "
        f"in {wrote:.3f} s; prepare_dataset cold {times[0]:.3f} s, from "
        f"its cache {times[1]:.3f} s; orbit sizes {sizes}; id "
        f"vocabulary {d_id}")

    # ---- phase 30: the path -------------------------------------------
    L = ZINC_CLI_LAYERS
    args, hist, modes, forms, evals = cli_path(
        card, root, "zinc-cli", *zinc_cli_f32_launches())
    args_bf, _h, modes_bf, forms_bf, _e = cli_path(
        card, root, "zinc-cli-bf16",
        {"edge_message_fwd": {"bf16": L, "bf16 id_sq": L},
         "edge_message_bwd_recv": {"bf16": L, "bf16 id_sq": L},
         "segment_sum_sorted": {"bf16->bf16": L, "f32->bf16": L,
                                "bf16->f32": 1},
         "segment_broadcast": {"bf16": 1}},
        {"edge_message_fwd": {"bf16": L},
         "segment_sum_sorted": {"bf16->f32": 1}},
        ({"warp": 2 * L, "block": 1}, {"block": 1}),
        "--compute_dtype", "bfloat16", "--num_epochs", "1",
        "--results_folder", "bf16")
    # the kernels on one train batch (phase 43 profiles whole epochs)
    _make, _train, data = zinc_cli_trainer(args, dev)
    rows = zinc_cli_kernels(dev, timed, data, CLI_D, empty, cpm,
                            main_pool)
    d = CLI_D
    for name, (on, path, kernel, mode) in {
            f"edge_message_fwd[bf16 d={d}]":
                (modes_bf, "zinc-cli-bf16", "edge_message_fwd", "bf16"),
            f"edge_message_fwd[id_sq bf16 d={d}]":
                (modes_bf, "zinc-cli-bf16", "edge_message_fwd",
                 "bf16 id_sq"),
            f"edge_message_bwd_recv[bf16 d={d}]":
                (modes_bf, "zinc-cli-bf16", "edge_message_bwd_recv",
                 "bf16"),
            f"edge_message_bwd_recv[id_sq bf16 d={d}]":
                (modes_bf, "zinc-cli-bf16", "edge_message_bwd_recv",
                 "bf16 id_sq"),
            f"segment_sum_sorted[f32 d={d}]":
                (forms, "zinc-cli", None, "warp"),
            f"segment_sum_sorted[pool f32 d={d}]":
                (forms, "zinc-cli", None, "block"),
            f"segment_sum_sorted[bf16->f32 d={d}]":
                (modes_bf, "zinc-cli-bf16", "segment_sum_sorted",
                 "bf16->f32"),
            f"segment_sum_sorted[bf16->bf16 d={d}]":
                (modes_bf, "zinc-cli-bf16", "segment_sum_sorted",
                 "bf16->bf16"),
            f"segment_sum_sorted[f32->bf16 d={d}]":
                (modes_bf, "zinc-cli-bf16", "segment_sum_sorted",
                 "f32->bf16"),
            f"segment_broadcast[f32 d={d}]":
                (modes, "zinc-cli", "segment_broadcast", "f32"),
            f"segment_broadcast[bf16 d={d}]":
                (modes_bf, "zinc-cli-bf16", "segment_broadcast", "bf16"),
            }.items():
        rows[name].update(launches=(on[kernel] if kernel else on)[mode],
                          path=path)

    # ---- phase 31: test and resume ------------------------------------
    tested = run_cli(zinc_cli_argv(root, "--mode", "test"))[0]
    want = hist["test_accs"][-1]
    if not np.isclose(tested["test_acc"], want, rtol=1e-5, atol=0):
        raise AssertionError(f"--mode test: metric {tested['test_acc']},"
                             f" training's last {want}")
    resumed = run_cli(zinc_cli_argv(root, "--resume", "True",
                                     "--num_epochs", "3"))[0]
    _d, recs = read_log(args)
    if [r["step"] for r in recs if "train_loss" in r][-1] != 2 or len(
            resumed["train_losses"]) != 1:
        raise AssertionError("--resume did not continue at epoch 2")
    straight = run_cli(zinc_cli_argv(root, "--num_epochs", "3",
                                      "--results_folder", "straight"))[0]
    # every sum on the path has a fixed order (K3's block form too),
    # so runs from one seed agree bit for bit, and so does a resume
    got, ref = resumed["train_losses"][-1], straight["train_losses"][-1]
    if hist["train_losses"] != straight["train_losses"][:2]:
        raise AssertionError(
            f"phase 30's first 2 epochs' train losses "
            f"{hist['train_losses']}, the uninterrupted run's "
            f"{straight['train_losses'][:2]}: not bit for bit")
    if got != ref:
        raise AssertionError(f"resumed epoch-3 train loss {got}, "
                             f"uninterrupted {ref}: not bit for bit")
    log(f"[zinc-cli] --mode test: metric {tested['test_acc']} (training's"
        f" last {want}); --resume True --num_epochs 3 trained epoch 2 "
        f"only: train loss {got}, uninterrupted 3 epochs {ref} (rel "
        f"{abs(got - ref) / abs(ref):.3e}); phase 30's and the "
        f"uninterrupted run's first 2 epochs' train losses "
        f"{hist['train_losses']} / {straight['train_losses'][:2]}, equal "
        f"{hist['train_losses'] == straight['train_losses'][:2]}")

    # ---- phase 32: isomorphism mode ---------------------------------
    write_sr16622(root)
    verdicts = {}
    for model, want in (("GSN_sparse", 0.0), ("MPNN_sparse", 1.0)):
        out = run_cli([
            "--seed", "0", "--dataset", "SR_graphs",
            "--dataset_name", "sr16622", "--root_folder", root,
            "--cache_folder", os.path.join(root, "cache_sr"),
            "--id_type", "complete_graph", "--k", "4",
            "--id_scope", "local", "--id_embedding", "one_hot_encoder",
            "--model_name", model, "--num_layers", "2", "--d_out", "64",
            "--msg_kind", "general", "--bn", "False", "--readout", "sum",
            "--final_projection", "False", "--jk_mlp", "True",
            "--mode", "isomorphism_test", "--wandb", "False"])
        if out["failure_percentage"] != want or out["pairs"] != 1:
            raise AssertionError(f"isomorphism {model}: {out}")
        verdicts[model] = out["failure_percentage"]
    log(f"[zinc-cli] isomorphism on SR(16,6,2,2) (4x4 rook's graph, "
        f"Shrikhande) on the card: failure {verdicts}")
    return rows, hist


def sweep_layout(dev):
    """Phase 33's segments: SWEEP_LENGTHS, then 300 segments of 0-4 rows,
    as (K3's ptr [S+1], starting 13 positions in, over rows of which 29
    trail the last segment; a permutation of the rows (positions -> row
    ids); K1's recv_ptr over the same lengths from edge 0, with a sender
    for each edge among the S nodes)."""
    rng = np.random.RandomState(9)
    lengths = np.r_[SWEEP_LENGTHS, rng.randint(0, 5, 300)]
    ends = np.cumsum(lengths)
    n_rows = 13 + int(ends[-1]) + 29
    as_dev = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        np.r_[13, 13 + ends], rng.permutation(n_rows), np.r_[0, ends],
        rng.randint(0, len(lengths), int(ends[-1])))]
    return (*as_dev, n_rows)


def order_check(got, want, abs_sum, counts, what):
    """A sum's kernel output against its plain version, which adds the
    same terms in another order: bf16 within one ulp (``bf16_check``);
    f32 within the f32 tolerances plus, for a row of n terms whose
    absolute values sum to S, 2 (n - 1) 2^-24 S (the worst-case error of
    two f32 sums of the same terms: the sweep's long rows cancel)."""
    if want.dtype == torch.bfloat16:
        return bf16_check(got, want, what)
    slack = 2 * (counts - 1).clamp(min=0)[:, None] * 2.0 ** -24 * abs_sum
    err = (got - want).abs()
    if not bool((err <= FWD_ATOL + FWD_RTOL * want.abs() + slack).all()):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version (max abs err {float(err.max())})")
    return float(err.max()) if err.numel() else 0.0


def width_sweep(dev):
    """Phase 33 (see module docstring); returns the number of cases, each
    equal to its plain version within its tolerance."""
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    ptr, perm, recv_ptr, send, n_rows = sweep_layout(dev)
    n_nodes, n_edges = recv_ptr.numel() - 1, send.numel()
    recv = k12.receivers(recv_ptr)
    f32, bf = torch.float32, torch.bfloat16
    cases = 0
    for d in SWEEP_D:
        gen = torch.Generator(device=dev).manual_seed(d)

        def rnd(*shape):
            return torch.randn(*shape, device=dev, generator=gen)

        rows = rnd(n_rows, d)
        for t_in, t_out, form, p in itertools.product(
                (f32, bf), (f32, bf), k3.FORMS, (None, perm)):
            x = rows.to(t_in)
            tag = (f"sweep K3 {form} {dtype_tag(t_in)}->{dtype_tag(t_out)} "
                   f"d={d}{' perm' if p is not None else ''}")
            got = k3.segment_sum_sorted_in(form, x, ptr, p, t_out)
            order_check(got, k3.segment_sum_sorted_plain(x, ptr, p, t_out),
                        k3.segment_sum_sorted_plain(x.abs(), ptr, p),
                        ptr.diff(), tag)
            if not torch.equal(got, k3.segment_sum_sorted_in(form, x, ptr,
                                                             p, t_out)):
                raise AssertionError(f"{tag}: two calls differ")
            cases += 1
        b1 = rnd(d)
        ops = rnd(n_nodes, d), rnd(n_nodes, d), rnd(n_edges + 29, d)
        for dtype, act, has_a, has_pe in itertools.product(
                (f32, bf), ("relu", "identity", "id_sq"), (True, False),
                (True, False)):
            A, B, Pe = (t.to(dtype) for t in ops)
            A, Pe = A if has_a else None, Pe if has_pe else None
            tag = (f"sweep K1 {dtype_tag(dtype)} {act} d={d} A={has_a} "
                   f"Pe={has_pe}")
            h = k12._pre_activation(A, B, Pe, b1, recv, send).abs()
            if act == "id_sq":
                h = torch.cat([h, h * h], dim=1)
            abs_sum = torch.zeros(n_nodes, h.shape[1], device=dev
                                  ).index_add_(0, recv, h)
            order_check(
                k12.edge_message_fwd(A, B, Pe, b1, recv_ptr, send, act),
                k12.edge_message_fwd_plain(A, B, Pe, b1, recv_ptr, send,
                                           act), abs_sum, recv_ptr.diff(),
                tag)
            cases += 1
            cases += k2_sweep_case(A, B, Pe, b1, recv_ptr, send, act,
                                   n_edges + 29, tag.replace("K1", "K2"))
    torch.cuda.synchronize()
    return cases


def k2_sweep_case(A, B, Pe, b1, recv_ptr, send, act, slots, tag):
    """Phase 33's K2 case on K1's operands and a random cotangent: dH
    against its plain version bit for bit (relu and identity: a masked
    copy of g) or at the f32 tolerances (id_sq: the kernel contracts
    g1 + 2 H g2 into one rounding), dA through ``order_check``, and a
    repeated call with the same bits; returns 1."""
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    n, d = recv_ptr.numel() - 1, B.shape[1]
    gen = torch.Generator(device=B.device).manual_seed(d + 1)
    g = torch.randn(n, 2 * d if act == "id_sq" else d, device=B.device,
                    generator=gen)
    if act != "id_sq":
        g = g.to(B.dtype)
    got = k12.edge_message_bwd_recv(A, B, Pe, b1, g, recv_ptr, send, act,
                                    slots)
    dH_p, dA_p = k12.edge_message_bwd_recv_plain(A, B, Pe, b1, g, recv_ptr,
                                                 send, act, slots)
    if act == "id_sq":
        max_err(got[0], dH_p, FWD_RTOL, FWD_ATOL, f"{tag} dH")
    else:
        exact(got[0], dH_p, f"{tag} dH")
    if A is not None:
        recv = k12.receivers(recv_ptr)
        abs_sum = torch.zeros(n, d, device=B.device).index_add_(
            0, recv, dH_p[:send.numel()].float().abs())
        order_check(got[1], dA_p, abs_sum, recv_ptr.diff(), f"{tag} dA")
    again = k12.edge_message_bwd_recv(A, B, Pe, b1, g, recv_ptr, send, act,
                                      slots)
    if not all(x is None or torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{tag}: two calls differ")
    return 1


def c3_phase(card, zinc, dgn):
    """Phase 34 (see module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from gsn_tpu_torch.nn.dgn import DGNNet
    from gsn_tpu_torch.train.loop import Trainer
    graphs, data, cfg, tcfg = zinc
    L = cfg.num_layers
    dgn_graphs, dgn_data = dgn
    dcfg, dtcfg = dgn_main_config(dgn_graphs)
    dcfg = dataclasses.replace(dcfg, aggregators=DGN_AGGS + ("var", "std"))
    Ld = dcfg.num_layers
    cases = (
        # K3: each layer's per-edge messages averaged at their receivers,
        # the backward of its two per-edge gathers and the L + 1 pools;
        # K4: the backward of the means and pools
        ("zinc-mean", dataclasses.replace(cfg, aggr="mean"), tcfg, graphs,
         data, None, {"segment_sum_sorted": 4 * L + 1,
                      "segment_broadcast": 2 * L + 1}, 2 * L + 1),
        # phase 10's launches, and K3 (K4 backward) for the two receiver
        # means each of var and std takes a layer
        ("dgn-var-std", dcfg, dtcfg, dgn_graphs, dgn_data, DGNNet,
         {"dgn_fused_fwd": Ld, "dgn_fused_bwd": Ld,
          "segment_sum_sorted": Ld + 2 + 4 * Ld,
          "segment_broadcast": 1 + 4 * Ld}, Ld + 2))
    counters = kernel_counters()
    for tag, c, tc, gs, d, model, per_step, k3_before in cases:
        runs = []
        for _ in range(2):
            tr = Trainer(c, tc, gs, model=model(c) if model else None)
            state, losses, _s, launches, _m = train_steps(
                tr, tr.init_state(seed=0), d, C3_STEPS, counters)
            expect_launches(launches, per_step, C3_STEPS, tag)
            runs.append(losses)
        if runs[0] != runs[1]:
            raise AssertionError(f"{tag}: two runs from one seed gave "
                                 f"{runs[0]} and {runs[1]}")
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        tr.train_step(state, d)
        torch.cuda.synchronize()
        prof.stop()
        names = {e.key for e in prof.key_averages()}
        hits = sorted(k for k in names if "index_add" in k)
        if hits:
            raise AssertionError(f"{tag}: a step ran {hits}")
        log(f"[c3] {tag}: two runs of {C3_STEPS} steps from seed 0, losses "
            f"{runs[0]} and {runs[1]}: bit for bit; launches in "
            f"{C3_STEPS} steps {launches} ({per_step} a step; K3 "
            f"{per_step['segment_sum_sorted']} a step against {k3_before} on "
            f"its add or no-var path); a profiled step ran {len(names)} ops "
            f"and kernels, none index_add ({card})")


def split_rows(tag, dt, act, shard, A, B, Pe, b1, g, timed, cpm, empty):
    """Phase 35's rows of K1, K2 and K3 (dB) in ``act`` mode on ``dt``
    data for one shard (its block of A and g, all of B): times, bounds
    from the rows the functions must touch, launch floors, and K1 on
    the same edges with the shard's senders compacted into B's first
    rows (the single-space form of the same call), which must give the
    same bits."""
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    seg = edge_segments(shard)
    rp, send = seg.recv_ptr, seg.send
    block, n, d = shard.num_node_slots, shard.num_real_edges, B.shape[1]
    slots = shard.num_edge_slots
    n_send_rows = B.shape[0]
    n_recv = int((rp.diff() > 0).sum())
    touched = torch.unique(send[:n].long())
    n_send = touched.numel()
    # padding slots (never read) map to row 0
    remap = torch.zeros((n_send_rows,), dtype=torch.int32, device=B.device)
    remap[touched] = torch.arange(n_send, dtype=torch.int32,
                                  device=B.device)
    send_c, B_c = remap[send.long()], B[touched].contiguous()
    out = k12.edge_message_fwd(A, B, Pe, b1, rp, send, act)
    exact(k12.edge_message_fwd(A, B_c, Pe, b1, rp, send_c, act), out,
          f"edge_message_fwd[{tag}] split vs compacted senders")
    t = 2 if dt == torch.bfloat16 else 4
    sq = act == "id_sq"
    idx = 4 * (block + 1 + n) + 4 * d
    gw = 4 * 2 * d if sq else t * d      # bytes of a g or moments row
    data_rows = t * (n_recv + n_send + n) * d   # A, B and Pe rows read
    fwd_b = bound(data_rows + n_recv * gw + idx, (7 if sq else 5) * n * d)
    dh_t = 4 if sq else t
    bwd_b = bound(data_rows + n_recv * gw + t * n_recv * d + dh_t * n * d
                  + idx, (8 if sq else 5) * n * d)
    dH, _ = k12.edge_message_bwd_recv(A, B, Pe, b1, g, rp, send, act, slots)
    k3_form = k3.segment_sum_form(n_send_rows, n)
    k3_b = bound(dh_t * n * d + t * n_send_rows * d
                 + 4 * (n_send_rows + 1 + n), n * d)
    src = "gsn_tpu_torch/csrc/"
    rows = {}
    for name, kernel, plain, (t_b, by), blocks, line, extra in (
            (f"edge_message_fwd[{tag}]",
             lambda: k12.edge_message_fwd(A, B, Pe, b1, rp, send, act),
             lambda: k12.edge_message_fwd_plain(A, B, Pe, b1, rp, send, act),
             fwd_b, k1_blocks(block), "slab_message.py:214",
             {"compact_ms": time_ms(lambda: k12.edge_message_fwd(
                 A, B_c, Pe, b1, rp, send_c, act), cpm)[0]}),
            (f"edge_message_bwd_recv[{tag}]",
             lambda: k12.edge_message_bwd_recv(A, B, Pe, b1, g, rp, send,
                                               act, slots),
             lambda: k12.edge_message_bwd_recv_plain(A, B, Pe, b1, g, rp,
                                                     send, act, slots),
             bwd_b, k2_blocks(block), "slab_message.py:240", {}),
            (f"segment_sum_sorted[{tag} dB]",
             lambda: k3.segment_sum_sorted(dH, seg.send_ptr, seg.send_perm,
                                           dt),
             lambda: k3.segment_sum_sorted_plain(dH, seg.send_ptr,
                                                 seg.send_perm, dt),
             k3_b, k3_blocks(k3_form, n_send_rows), "slab_combine.py:77",
             {"form": k3_form})):
        rows[name] = dict(
            source=src + ("segment_sum.cu" if "segment" in name
                          else "edge_message.cu"),
            replaces=f"gsn_tpu/ops/pallas/{line}", bound_ms=t_b,
            bound_by=by, floor_ms=launch_floor_ms(empty, cpm, blocks),
            blocks=blocks, **extra, **timed(kernel, plain))
    log(f"[num_send] {tag} shard 0: {n} edges, {n_recv} of {block} "
        f"receivers with edges, {n_send} of {n_send_rows} sender rows "
        f"touched; K1 with its senders compacted gives the same bits")
    return rows


def split_mode_phase(dev, timed, host_batch, cpm, empty):
    """Phase 35 (see module docstring); returns its kernel rows."""
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.parallel import make_ep_batch
    data = host_batch.to(dev)
    shards = [s.to(dev) for s in make_ep_batch(host_batch, SPLIT_D)]
    N, E = data.num_node_slots, data.num_edge_slots
    block = N // SPLIT_D
    whole = edge_segments(data)
    gen = torch.Generator(device=dev).manual_seed(35)
    log(f"[num_send] make_zinc_like(1024)'s batch ({N} node slots, "
        f"{data.num_real_edges} edges) over {SPLIT_D} shards of {block} "
        f"receiver rows: {[s.num_real_edges for s in shards]} edges")
    rows = {}
    for dt_name, act in SPLIT_MODES:
        dt = torch.bfloat16 if dt_name == "bf16" else torch.float32
        tag = f"num_send {dt_name} {act}"
        A, B = (torch.randn(N, D, device=dev, generator=gen).to(dt)
                for _ in range(2))
        Pe = torch.randn(E, D, device=dev, generator=gen).to(dt)
        b1 = torch.randn(D, device=dev, generator=gen)
        g = torch.randn(N, 2 * D if act == "id_sq" else D, device=dev,
                        generator=gen)
        g = g if act == "id_sq" else g.to(dt)

        def close(got, want, what):
            if got.dtype == torch.bfloat16:
                return bf16_check(got, want, what)
            return max_err(got, want, FWD_RTOL, FWD_ATOL, what)

        outs, e0, errs = [], 0, {"fwd": 0.0, "bwd": 0.0, "dB": 0.0}
        ops = []
        for r, shard in enumerate(shards):
            seg = edge_segments(shard)
            n, slots = shard.num_real_edges, shard.num_edge_slots
            rr = slice(r * block, (r + 1) * block)
            a, gr = A[rr], g[rr]
            pe = torch.zeros(slots, D, dtype=dt, device=dev)
            pe[:n] = Pe[e0:e0 + n]
            ops.append((shard, a, pe, gr))
            rp, send = seg.recv_ptr, seg.send
            out = k12.edge_message_fwd(a, B, pe, b1, rp, send, act)
            errs["fwd"] = max(errs["fwd"], close(
                out, k12.edge_message_fwd_plain(a, B, pe, b1, rp, send, act),
                f"edge_message_fwd[{tag}] shard {r}"))
            dH, dA = k12.edge_message_bwd_recv(a, B, pe, b1, gr, rp, send,
                                               act, slots)
            dH_p, dA_p = k12.edge_message_bwd_recv_plain(
                a, B, pe, b1, gr, rp, send, act, slots)
            if act == "id_sq":
                errs["bwd"] = max(errs["bwd"], max_err(
                    dH, dH_p, FWD_RTOL, FWD_ATOL, f"[{tag}] dH"))
            else:
                exact(dH, dH_p, f"edge_message_bwd_recv[{tag}] dH")
            errs["bwd"] = max(errs["bwd"], bf16_check(dA, dA_p, f"[{tag}] dA")
                              if dA.dtype == torch.bfloat16
                              else grad_check([dA], [dA_p], f"[{tag}] dA"))
            dB = k3.segment_sum_sorted(dH, seg.send_ptr, seg.send_perm, dt)
            if dB.shape != (N, D):
                raise AssertionError(f"[{tag}] dB shape {tuple(dB.shape)}")
            errs["dB"] = max(errs["dB"], close(
                dB, k3.segment_sum_sorted_plain(dH, seg.send_ptr,
                                                seg.send_perm, dt),
                f"segment_sum_sorted[{tag} dB] shard {r}"))
            outs.append(out)
            e0 += n
        exact(torch.cat(outs), k12.edge_message_fwd(
            A, B, Pe, b1, whole.recv_ptr, whole.send, act),
            f"edge_message_fwd[{tag}]: the shards stacked against the "
            f"unpartitioned call")
        shard, a, pe, gr = ops[0]
        got = split_rows(tag, dt, act, shard, a, B, pe, b1, gr, timed, cpm,
                         empty)
        for name, err in zip(got, errs.values()):
            got[name]["max_abs_err"] = err
        for name, row in got.items():
            log_row("num_send", name, row)
        rows.update(got)
        log(f"[num_send] {tag}: {SPLIT_D} shards against the plain "
            f"versions (max abs err {errs}); their stacked K1 outputs equal "
            f"the unpartitioned K1's bit for bit")
    torch.cuda.synchronize()
    return rows


def parallel_phase(card, zinc, host_batch, single_losses, rows, root):
    """Phase 36 (see module docstring); fills the launches of phase 35's
    rows from the ep runs."""
    import torch.distributed as dist

    from gsn_tpu_torch.parallel import (ParallelTrainer, init_rank,
                                        make_ep_batch, make_mesh)
    graphs, data, cfg, tcfg = zinc
    L = cfg.num_layers
    init_rank(0, 1, "cuda", os.path.join(root, "rendezvous"))
    try:
        counters = kernel_counters()
        k3 = counters["segment_sum_sorted"]
        shards = {"dp": data,
                  "ep": make_ep_batch(host_batch, 1, rank=0).to(data.x.device)}
        per_step = {"edge_message_fwd": L, "edge_message_bwd_recv": L,
                    "segment_sum_sorted": 2 * L + 1,
                    "segment_broadcast": L + 1}
        trainers = {}
        for mode in ("dp", "ep"):
            mesh = make_mesh(axis_names=(mode,))
            tr = trainers[mode] = ParallelTrainer(cfg, tcfg, graphs,
                                                  mesh=mesh, mode=mode)
            state, losses, step_s, launches, _m = train_steps(
                tr, tr.init_state(seed=0), shards[mode], STEPS, counters)
            forms = dict(k3.forms)
            expect_launches(launches, per_step, STEPS, f"zinc-{mode} path")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"zinc-{mode}: loss did not fall: "
                                     f"{losses}")
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, single_losses))
            if rel > FWD_RTOL:
                raise AssertionError(f"zinc-{mode}: losses {losses}, the "
                                     f"single-device trainer's "
                                     f"{single_losses} (rel {rel})")
            med = statistics.median(step_s[1:])
            log(f"[zinc-{mode}] NCCL world size 1: losses {losses}; against"
                f" the single-device Trainer's (phase 5) max rel {rel:.3e},"
                f" bit for bit {losses == single_losses}; launches in "
                f"{STEPS} steps {launches}; train step median "
                f"{med * 1e3:.3f} ms over {STEPS - 1} steps (first "
                f"{step_s[0] * 1e3:.1f} ms), "
                f"{data.num_real_edges / med:.4e} real edges/s ({card})")
            profile_steps(tr, state, shards[mode], med * 1e3, f"zinc-{mode}")
        steps_in_turns(card, cfg, tcfg, graphs, shards, trainers)
        ep_runs = {"f32 relu": (launches, forms, "zinc-ep")}
        mesh = make_mesh(axis_names=("ep",))
        # the ep path in bf16 and with the fused-BN message MLP (f32
        # id_sq under ep): the split mode's other rows' launches
        for tag, path, over, each, each_modes in (
                ("bf16 relu", "zinc-ep-bf16", {"compute_dtype": "bfloat16"},
                 per_step,
                 {"edge_message_fwd": {"bf16": L},
                  "edge_message_bwd_recv": {"bf16": L},
                  "segment_sum_sorted": {"bf16->bf16": L, "bf16->f32": L + 1},
                  "segment_broadcast": {"bf16": L + 1}}),
                ("f32 id_sq", "zinc-ep-bnmlp", {"bn_mlp": True},
                 {"edge_message_fwd": 2 * L, "edge_message_bwd_recv": 2 * L,
                  "segment_sum_sorted": 3 * L + 1,
                  "segment_broadcast": L + 1},
                 {"edge_message_fwd": {"f32": L, "f32 id_sq": L},
                  "edge_message_bwd_recv": {"f32": L, "f32 id_sq": L},
                  "segment_sum_sorted": {"f32->f32": 3 * L + 1},
                  "segment_broadcast": {"f32": L + 1}})):
            tr = ParallelTrainer(dataclasses.replace(cfg, **over), tcfg,
                                 graphs, mesh=mesh, mode="ep")
            state, losses, _s, launches, modes = train_steps(
                tr, tr.init_state(seed=0), shards["ep"], C3_STEPS, counters)
            expect_launches(launches, each, C3_STEPS, f"zinc-ep {tag}",
                            modes, each_modes)
            ep_runs[tag] = (modes, dict(k3.forms), path)
            log(f"[zinc-ep] {tag}: {C3_STEPS} steps, losses {losses}, "
                f"launches by mode {modes}")
        for tag, (on, forms, path) in ep_runs.items():
            dt, act = tag.split()
            mode = dt + (" id_sq" if act == "id_sq" else "")
            for kernel in ("edge_message_fwd", "edge_message_bwd_recv"):
                n = on[kernel]
                rows[f"{kernel}[num_send {tag}]"].update(
                    launches=n if isinstance(n, int) else n[mode], path=path)
            # dB: K3's warp form (the pools take the block form)
            rows[f"segment_sum_sorted[num_send {tag} dB]"].update(
                launches=(on["segment_sum_sorted"]["bf16->bf16"]
                          if dt == "bf16" else forms["warp"]), path=path)
    finally:
        dist.destroy_process_group()


def steps_in_turns(card, cfg, tcfg, graphs, shards, trainers):
    """Phase 36's host costs: one collective of the port at world size 1
    (host time a call, 200 calls queued), and a step of one device, dp
    and ep in turns (TURNS rounds, the median of the last TURNS - 2)."""
    from gsn_tpu_torch.parallel import collectives
    from gsn_tpu_torch.train.loop import Trainer
    dev = shards["dp"].x.device
    small = torch.randn(257, device=dev)
    block = torch.randn(shards["dp"].num_node_slots // SPLIT_D, D,
                        device=dev)
    host_us = {}
    for name, fn in (("all_reduce[257]",
                      lambda: collectives.all_reduce(small, "dp")),
                     (f"all_gather[{block.shape[0]}x{D}]",
                      lambda: collectives.all_gather(block, "ep"))):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    runs = {"one device": (Trainer(cfg, tcfg, graphs), shards["dp"]),
            "dp": (trainers["dp"], shards["dp"]),
            "ep": (trainers["ep"], shards["ep"])}
    states = {k: tr.init_state(seed=0) for k, (tr, _d) in runs.items()}
    times = {k: [] for k in runs}
    for _ in range(TURNS):
        for k, (tr, data) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(states[k], data)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    log(f"[parallel] host time a collective call at world size 1 (us): "
        f"{host_us}; a train step in turns, median ms of {TURNS - 2}: "
        f"{ {k: statistics.median(v[2:]) for k, v in times.items()} } "
        f"({card})")


def cli_parallel_phase(root, serial_hist):
    """Phase 37 (see module docstring)."""
    for mode in ("dp", "ep"):
        t0 = time.perf_counter()
        hist = run_cli(zinc_cli_argv(
            root, "--parallel", mode, "--parallel_devices", "1",
            "--num_epochs", "1", "--results_folder", f"parallel-{mode}"))[0]
        wall = time.perf_counter() - t0
        for key, vals in hist.items():
            if len(vals) != 1 or not np.isfinite(vals).all():
                raise AssertionError(f"--parallel {mode}: history {key} = "
                                     f"{vals}")
        got, want = hist["train_losses"][0], serial_hist["train_losses"][0]
        rel = abs(got - want) / abs(want)
        if rel > CLI_PARALLEL_RTOL:
            raise AssertionError(f"--parallel {mode}: first epoch's train "
                                 f"loss {got}, the serial run's {want}")
        log(f"[zinc-cli-{mode}] --parallel {mode} --parallel_devices 1: one "
            f"epoch in {wall:.3f} s (one spawned NCCL rank); train loss "
            f"{got}, phase 30's serial first epoch {want} (rel {rel:.3e}, "
            f"bit for bit {got == want}); history {hist}")


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def coordinator_argv(port, *extra):
    """The multi-process flags of one process joining a coordinator on
    ``port`` (world size 1), one epoch, and ``extra``."""
    return ("--coordinator_address", f"127.0.0.1:{port}",
            "--num_procs_distributed", "1", "--process_id", "0",
            "--num_epochs", "1", *extra)


def coordinator_cli_phase(card, root, serial_hist, rows):
    """Phase 41 (see module docstring); fills the launches of the f32
    K1/K2 rows at d=150 from the ep run."""
    import contextlib
    import io

    import torch.distributed as dist

    from gsn_tpu_torch import cli
    said = "multi-process run: defaulting --parallel to 'dp'"
    launches = {"dp": zinc_cli_f32_launches(),
                "ep": zinc_cli_ep_launches()}
    first = {}
    for mode, extra in (("dp", ()), ("ep", ("--parallel", "ep"))):
        tag = f"zinc-cli-coord-{mode}"
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            args, hist, modes, _f, _e = cli_path(
                card, root, tag, *launches[mode],
                *coordinator_argv(free_port(), "--results_folder", tag,
                                  *extra))
        wall = time.perf_counter() - t0
        sys.stdout.write(out.getvalue())
        if (said in out.getvalue()) != (mode == "dp"):
            raise AssertionError(f"{tag}: the dp default's line printed "
                                 f"{said in out.getvalue()}")
        if dist.is_initialized():
            raise AssertionError(f"{tag}: the group outlived cli.main")
        run_dir, recs = read_log(args)
        files = sorted(os.listdir(run_dir))
        ckpts = os.listdir(os.path.dirname(cli.checkpoint_path(args, -1)))
        if files != ["checkpoints", "log.jsonl", "params.json"] or len(
                ckpts) != 1 or sum("train_loss" in r for r in recs) != 1:
            raise AssertionError(f"{tag}: wrote {files}, checkpoints "
                                 f"{ckpts}, {len(recs)} log records")
        got, want = hist["train_losses"][0], serial_hist["train_losses"][0]
        rel = abs(got - want) / abs(want)
        if rel > CLI_PARALLEL_RTOL:
            raise AssertionError(f"{tag}: first epoch's train loss {got}, "
                                 f"phase 30's {want}")
        first[mode] = got
        if mode == "ep":
            for kernel in ("edge_message_fwd", "edge_message_bwd_recv"):
                for on, name in (("f32", "f32"), ("f32 id_sq", "id_sq f32")):
                    rows[f"{kernel}[{name} d={CLI_D}]"].update(
                        launches=modes[kernel][on], path=tag)
        how = ", --parallel ep" if extra else ", dp by default"
        log(f"[{tag}] cli.main with --coordinator_address (NCCL world size "
            f"1, in this process{how}): one epoch in {wall:.3f} s; train "
            f"loss {got}, phase 30's "
            f"serial first epoch {want} (rel {rel:.3e}, bit for bit "
            f"{got == want}); launches a step "
            f"{'as phase 30' if mode == 'dp' else 'the ep route'}'s; one "
            f"log, one checkpoint; no group left ({card})")

    # the same flags in a process of its own
    tag = "zinc-cli-coord-os"
    argv = zinc_cli_argv(root, *coordinator_argv(
        free_port(), "--results_folder", tag))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gsn_tpu_torch.cli", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: exit {proc.returncode}\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    if said not in proc.stdout:
        raise AssertionError(f"{tag}: no dp default line")
    _d, recs = read_log(vars(cli.build_parser().parse_args(argv)))
    got = [r["train_loss"] for r in recs if "train_loss" in r]
    if got != [first["dp"]]:
        raise AssertionError(f"{tag}: train losses {got}, the in-process "
                             f"run's {first['dp']}")
    log(f"[{tag}] python -m gsn_tpu_torch.cli with the same flags: exit 0 "
        f"in {wall:.3f} s (process start and kernel loading included); "
        f"first epoch's train loss {got[0]}, the in-process run's bit for "
        f"bit ({card})")


# phase 43: rounds of a graphed and a per-step epoch in turns, and the
# molhiv path's batch (32 steps an epoch of make_molhiv_like(1024)'s
# 1024 graphs, 896 of them trained on)
EPOCH_TURNS = 3
MOLHIV_BATCH = 32


def epochs_run(make, splits, epochs, seed):
    """``epochs`` epochs of a fresh trainer ``make()`` from ``seed`` on
    ``splits[0]``, each then evaluated on ``splits[1:]``: a dict of the
    train losses, evaluations, final state dict, per-epoch stats, the
    trainer and the state."""
    trainer = make()
    state = trainer.init_state(seed=seed)
    losses, evals, stats = [], [], []
    for _ in range(epochs):
        state, loss = trainer.train_epoch(state, splits[0])
        losses.append(loss)
        stats.append(dict(trainer.epoch_stats))
        evals.append([trainer.evaluate(state, s) for s in splits[1:]])
    params = {k: v.detach().clone()
              for k, v in state.model.state_dict().items()}
    return dict(losses=losses, evals=evals, params=params, stats=stats,
                trainer=trainer, state=state)


def same_bits(a, b):
    return (a["losses"] == b["losses"] and a["evals"] == b["evals"]
            and all(torch.equal(v, b["params"][k])
                    for k, v in a["params"].items()))


def graphed_paths(root):
    """Phase 43's paths: (tag, make(scan) -> Trainer, splits, epochs,
    seed, whether graphed and per-step must agree bit for bit)."""
    from gsn_tpu_torch import cli
    from gsn_tpu_torch import cli_directional as dcli
    from gsn_tpu_torch.data.synthetic import make_molhiv_like
    from gsn_tpu_torch.train.loop import Trainer, TrainerConfig
    paths = []
    for tag, argv, epochs in (
            ("zinc-cli", zinc_cli_argv(root), 2),
            ("zinc-cli-bf16", zinc_cli_argv(
                root, "--compute_dtype", "bfloat16"), 1)):
        args = vars(cli.build_parser().parse_args(argv))
        graphs, cfg = cli.prepare(args)
        train, test, val = cli.fold_splits(args, graphs, -1)
        tcfg = cli.trainer_config(args)
        paths.append((tag, lambda scan, cfg=cfg, tcfg=tcfg, train=train:
                      cli.Trainer(cfg, dataclasses.replace(
                          tcfg, scan_epochs=scan), train),
                      [train, train, test, val], epochs, args["seed"], True))
    graphs, d_id = make_molhiv_like(1024)
    cfg = molhiv_cfg(d_id)
    tcfg = TrainerConfig(lr=1e-3, batch_size=MOLHIV_BATCH, scheduler="None",
                         loss_fn="BCEWithLogitsLoss", prediction_fn="None",
                         evaluator="rocauc")
    paths.append(("molhiv", lambda scan: Trainer(cfg, dataclasses.replace(
        tcfg, scan_epochs=scan), graphs[:896]),
        [graphs[:896], graphs[:896], graphs[896:]], 2, 0, False))
    args = vars(dcli.build_parser().parse_args(dgn_cli_argv(root)))
    train, val, test, _tasks = dcli.prepare(dict(args))
    dcfg = dcli.model_config(args, dcli.compute_avg_d(train), 1)
    dtcfg = dcli.trainer_config(args)
    paths.append(("dgn-cli", lambda scan: dcli.Trainer(
        dcfg, dataclasses.replace(dtcfg, scan_epochs=scan), train,
        model=dcli.DGNNet(dcfg)), [train, val, test], 2, args["seed"],
        False))
    return paths


def run_numbers(run):
    """A run's train losses and evaluations, flat, in f64."""
    return np.asarray(run["losses"] + list(np.ravel(run["evals"])),
                      np.float64)


def max_diffs(a, b):
    """(largest relative difference of the losses and evaluations, of
    any parameter or statistic) between two runs."""
    x, y = run_numbers(a), run_numbers(b)
    rel = float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30)))
    par = max(float((v.float() - b["params"][k].float()).abs().max())
              for k, v in a["params"].items() if v.is_floating_point())
    return rel, par


def sync_reads(fn):
    """(fn's result, where each blocking device read it made happened: the
    innermost frames of the call, file:line), from
    ``torch.cuda.set_sync_debug_mode``'s warnings.  The collector runs
    first and is off meanwhile: freeing another object's CUDA graphs
    (earlier runs' trainers are cyclic garbage) synchronizes the card
    wherever a collection happens to fall."""
    import gc
    import traceback
    import warnings
    gc.collect()
    torch.cuda.synchronize()
    gc.disable()
    reads, inside = [], [False]

    def show(message, category, filename, lineno, file=None, line=None):
        # only while fn runs: toggling the mode is not fn's read
        if inside[0] and "synchroniz" in str(message):
            reads.append(" < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}"
                for f in traceback.extract_stack()[-5:-1][::-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside[0] = True
            out = fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode("default")
            gc.enable()
    return out, reads


def graphed_and_per_step(tag, make, splits, epochs, seed, bitwise):
    """Phases 43 and 44: ``epochs_run`` graphed, per step and graphed
    again from ``seed``.  The two graphed runs must agree bit for bit,
    and so must the graphed and the per-step run where ``bitwise``, else
    at the f32 tolerances.  Returns (the graphed run, the per-step run,
    whether they agree bit for bit, their largest differences, the
    graphed run's peak memory above the ``held`` memory, held)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    g = epochs_run(lambda: make(True), splits, epochs, seed)
    peak = torch.cuda.max_memory_allocated() - held
    p = epochs_run(lambda: make(False), splits, epochs, seed)
    again = epochs_run(lambda: make(True), splits, epochs, seed)
    if not same_bits(g, again):
        raise AssertionError(f"[graphed {tag}] two graphed runs differ: "
                             f"{max_diffs(g, again)}")
    del again
    equal = same_bits(g, p)
    rel, par = max_diffs(g, p)
    if not equal:
        if bitwise:
            raise AssertionError(f"[graphed {tag}] graphed and per-step "
                                 f"runs differ: rel {rel}, params {par}")
        max_err(torch.from_numpy(run_numbers(g)),
                torch.from_numpy(run_numbers(p)), FWD_RTOL, FWD_ATOL,
                f"[graphed {tag}] losses and evaluations")
        grad_check([v for v in g["params"].values()
                    if v.is_floating_point()],
                   [v for v in p["params"].values()
                    if v.is_floating_point()],
                   f"[graphed {tag}] parameters")
    return g, p, equal, (rel, par), peak, held


def graphed_epochs_phase(card, root):
    """Phase 43 (see module docstring)."""
    for tag, make, splits, epochs, seed, bitwise in graphed_paths(root):
        g, p, equal, (rel, par), peak, held = graphed_and_per_step(
            tag, make, splits, epochs, seed, bitwise)
        log(f"[graphed {tag}] {epochs} epochs from seed {seed}: graphed and "
            f"per-step bit for bit {equal} (largest relative difference of "
            f"losses and evaluations {rel}, of parameters {par}); two "
            f"graphed runs bit for bit; train losses {g['losses']}; "
            f"evaluations {g['evals']}; {len(g['trainer']._graphs)} graphs "
            f"held")
        log(f"[graphed {tag}] capture_s by epoch "
            f"{[st['capture_s'] for st in g['stats']]}; a replay's device "
            f"time (median) by epoch "
            f"{[st['step_median_s'] * 1e3 for st in g['stats']]} ms; the "
            f"per-step epochs' median step (host) "
            f"{[st['step_median_s'] * 1e3 for st in p['stats']]} ms; steps "
            f"an epoch {g['stats'][0]['steps']}; peak memory of the graphed "
            f"run {peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB "
            f"held ({card})")
        secs = {"graphed": [], "per-step": []}
        for r in range(EPOCH_TURNS):
            order = (("graphed", g), ("per-step", p))
            for name, run in (order if r % 2 == 0 else order[::-1]):
                run["state"], _ = run["trainer"].train_epoch(run["state"],
                                                             splits[0])
                secs[name].append(run["trainer"].epoch_stats["epoch_s"])
        if g["trainer"].epoch_stats["capture_s"] != 0.0:
            raise AssertionError(f"[graphed {tag}] a cached epoch captured")
        log(f"[graphed {tag}] epoch seconds in turns ({EPOCH_TURNS} "
            f"rounds): graphed {secs['graphed']}, per step "
            f"{secs['per-step']}; a graphed epoch's replay device time "
            f"{g['trainer'].epoch_stats['step_median_s'] * 1e3} ms a step "
            f"({card})")
        if tag != "zinc-cli":
            continue
        trainer, train = g["trainer"], splits[0]

        def epoch():
            g["state"], _ = trainer.train_epoch(g["state"], train)

        _o, reads = sync_reads(epoch)
        _o, eval_reads = sync_reads(lambda: trainer.evaluate(g["state"],
                                                             splits[2]))
        if len(reads) > 1 or len(eval_reads) > 1:
            raise AssertionError(f"[graphed {tag}] blocking reads at "
                                 f"{reads} in a one-run epoch, at "
                                 f"{eval_reads} in a one-run split")
        log(f"[graphed {tag}] under set_sync_debug_mode: a cached graphed "
            f"epoch (one run) made {len(reads)} blocking device read(s) "
            f"({reads}), an evaluation of the test split (one run) "
            f"{len(eval_reads)} ({eval_reads})")
        p["state"] = profile_epoch(p["trainer"], p["state"], train,
                                   statistics.median(secs["per-step"]),
                                   f"{tag} per-step")
        g["state"] = profile_epoch(trainer, g["state"], train,
                                   statistics.median(secs["graphed"]),
                                   f"{tag} graphed")


# phase 44: the epochs of each graphed parallel path (fewer than phase
# 43's, the run's time kept near its length before phase 44)
PARALLEL_EPOCHS = 1


def graphed_parallel_paths(root):
    """Phase 44's paths on this process's group: (tag, make(scan) ->
    ParallelTrainer, splits, seed, whether graphed and per-step must
    agree bit for bit, a train step's launches by kernel and mode)."""
    from gsn_tpu_torch import cli
    from gsn_tpu_torch import cli_directional as dcli
    from gsn_tpu_torch.parallel import ParallelTrainer, distributed
    args = vars(cli.build_parser().parse_args(zinc_cli_argv(root)))
    graphs, cfg = cli.prepare(args)
    train, test, val = cli.fold_splits(args, graphs, -1)
    tcfg = cli.trainer_config(args)
    paths = []
    for mode, per_train in (("dp", zinc_cli_f32_launches()[0]),
                            ("ep", zinc_cli_ep_launches()[0])):
        paths.append((f"zinc-cli-{mode}", lambda scan, mode=mode,
                      train=train: ParallelTrainer(
                          cfg, dataclasses.replace(tcfg, scan_epochs=scan),
                          train, mesh=distributed.global_mesh(mode),
                          mode=mode),
                      [train, train, test, val], args["seed"], True,
                      per_train))
    args = vars(dcli.build_parser().parse_args(dgn_cli_argv(
        root, "--parallel", "dp")))
    train, val, test, _tasks = dcli.prepare(dict(args))
    dcfg = dcli.model_config(args, dcli.compute_avg_d(train), 1)
    dtcfg = dcli.trainer_config(args)
    L = args["L"]
    paths.append(("dgn-cli-dp", lambda scan: ParallelTrainer(
        dcfg, dataclasses.replace(dtcfg, scan_epochs=scan), train,
        mesh=distributed.global_mesh("dp"), mode="dp",
        model=dcli.DGNNet(dcfg)), [train, val, test], args["seed"], False,
        # phase 40's train step
        {"dgn_fused_fwd": L, "dgn_fused_bwd": L,
         "segment_sum_sorted": L + 2, "segment_broadcast": 1}))
    return paths


def check_epoch_launches(tag, name, trainer, counters, per_train):
    """The launches of the train epoch ``trainer`` just ran (the counters
    zeroed just before it) must be ``per_train`` (a train step's, by
    kernel and mode, or by kernel) times its steps, and nothing else;
    returns (launches by kernel, by kernel and mode)."""
    torch.cuda.synchronize()
    steps = trainer.epoch_stats["steps"]
    launches = {n: fn.launches for n, fn in counters.items() if fn.launches}
    modes = {n: dict(fn.modes) for n, fn in counters.items() if fn.modes}
    for kernel, want in per_train.items():
        got = (modes.get(kernel, {}) if isinstance(want, dict)
               else launches.get(kernel, 0))
        want = ({m: c * steps for m, c in want.items()}
                if isinstance(want, dict) else want * steps)
        if got != want:
            raise AssertionError(f"[graphed {tag}] {name}: {kernel} "
                                 f"launched {got} in {steps} steps, "
                                 f"expected {want}")
    if set(launches) != set(per_train):
        raise AssertionError(f"[graphed {tag}] {name}: launched "
                             f"{launches}, expected only {per_train}")
    return launches, modes


def graphed_parallel_phase(card, root):
    """Phase 44 (see module docstring)."""
    from gsn_tpu_torch.parallel import distributed
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        for tag, make, splits, seed, bitwise, per_train in \
                graphed_parallel_paths(root):
            graphed_parallel_path(card, tag, make, splits, seed, bitwise,
                                  per_train)
    finally:
        distributed.shutdown()


def graphed_parallel_path(card, tag, make, splits, seed, bitwise,
                          per_train):
    """One path of phase 44: graphed, per step and graphed again from
    one seed; bits, launches, blocking reads, times and a profile."""
    epochs, train = PARALLEL_EPOCHS, splits[0]
    g, p, equal, (rel, par), peak, held = graphed_and_per_step(
        tag, make, splits, epochs, seed, bitwise)
    if not (g["trainer"].tcfg.scan_epochs and g["trainer"]._graphs):
        raise AssertionError(f"[graphed {tag}] the parallel trainer ran "
                             f"no graphs")
    log(f"[graphed {tag}] NCCL world size 1, {epochs} epoch(s) from seed "
        f"{seed}: graphed and per-step bit for bit {equal} (largest "
        f"relative difference of losses and evaluations {rel}, of "
        f"parameters {par}); two graphed runs bit for bit; train losses "
        f"{g['losses']}; evaluations {g['evals']}; "
        f"{len(g['trainer']._graphs)} graphs held")
    log(f"[graphed {tag}] capture_s {[st['capture_s'] for st in g['stats']]}"
        f"; a replay's device time (median) "
        f"{[st['step_median_s'] * 1e3 for st in g['stats']]} ms; the "
        f"per-step epoch's median step (host) "
        f"{[st['step_median_s'] * 1e3 for st in p['stats']]} ms; steps an "
        f"epoch {g['stats'][0]['steps']}; peak memory of the graphed run "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held "
        f"({card})")
    # epochs in turns; the first round's, counted, show that a cached
    # replay launches what a per-step step does
    from gsn_tpu_torch.ops.cuda import build
    counters = kernel_counters()
    secs = {"graphed": [], "per-step": []}
    counted = {}
    for r in range(EPOCH_TURNS):
        order = (("graphed", g), ("per-step", p))
        for name, run in (order if r % 2 == 0 else order[::-1]):
            for fn in counters.values():
                build.reset(fn)
            run["state"], _ = run["trainer"].train_epoch(run["state"],
                                                         train)
            secs[name].append(run["trainer"].epoch_stats["epoch_s"])
            if r == 0:
                counted[name] = check_epoch_launches(
                    tag, name, run["trainer"], counters, per_train)
    if g["trainer"].epoch_stats["capture_s"] != 0.0:
        raise AssertionError(f"[graphed {tag}] a cached epoch captured")
    if counted["graphed"] != counted["per-step"]:
        raise AssertionError(f"[graphed {tag}] launches graphed "
                             f"{counted['graphed']}, per step "
                             f"{counted['per-step']}")
    log(f"[graphed {tag}] launches in an epoch of "
        f"{g['trainer'].epoch_stats['steps']} steps, graphed = per step: "
        f"{counted['graphed'][1] or counted['graphed'][0]} ({per_train} a "
        f"train step)")
    log(f"[graphed {tag}] epoch seconds in turns ({EPOCH_TURNS} rounds): "
        f"graphed {secs['graphed']}, per step {secs['per-step']}; a "
        f"graphed epoch's replay device time "
        f"{g['trainer'].epoch_stats['step_median_s'] * 1e3} ms a step "
        f"({card})")
    trainer = g["trainer"]

    def epoch():
        g["state"], _ = trainer.train_epoch(g["state"], train)

    _o, reads = sync_reads(epoch)
    _o, eval_reads = sync_reads(lambda: trainer.evaluate(g["state"],
                                                         splits[-1]))
    if len(reads) > 1 or len(eval_reads) > 1:
        raise AssertionError(f"[graphed {tag}] blocking reads at {reads} "
                             f"in a one-run epoch, at {eval_reads} in a "
                             f"one-run split")
    log(f"[graphed {tag}] under set_sync_debug_mode: a cached graphed "
        f"epoch (one run) made {len(reads)} blocking device read(s) "
        f"({reads}), an evaluation of a split (one run) "
        f"{len(eval_reads)} ({eval_reads})")
    g["state"] = profile_epoch(trainer, g["state"], train,
                               statistics.median(secs["graphed"]),
                               f"{tag} graphed")


# phase 42: scaling_efficiency_bench's defaults and the reference test's
# message
EP_NODES, EP_DEGREE, EP_D = 8192, 8, 128


def edge_partition_phase(dev, card, timed):
    """Phase 42 (see module docstring); returns the propagate's K3 and K4
    rows."""
    from gsn_tpu_torch.ops.cuda import build
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_pool as k4
    from gsn_tpu_torch.ops.segment import masked_segment_sum
    from gsn_tpu_torch.parallel import distributed
    from gsn_tpu_torch.parallel import edge_partition as ep

    n, d, E = EP_NODES, EP_D, EP_NODES * EP_DEGREE
    rng = np.random.RandomState(0)
    ei = np.stack([rng.randint(0, n, E), rng.randint(0, n, E)])
    x = rng.randn(n, d).astype(np.float32)
    cot = rng.randn(n, d).astype(np.float32)

    def message(xi, xj):
        return torch.tanh(xi) + 2.0 * xj

    # the plain CPU version: one device, index_add over every edge
    x_cpu = torch.from_numpy(x).requires_grad_(True)
    recv, send = (torch.from_numpy(a).long() for a in ei)
    want = masked_segment_sum(message(x_cpu[recv], x_cpu[send]), recv, n)
    (want_g,) = torch.autograd.grad((want * torch.from_numpy(cot)).sum(),
                                    [x_cpu])
    kinds = (("all-gather", ep.partition_edges_by_receiver,
              ep.edge_partitioned_propagate),
             ("ring", ep.partition_edges_ring,
              ep.ring_edge_partitioned_propagate))
    counters = kernel_counters()
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = distributed.global_mesh("ep")
        inputs = [(name, propagate(mesh, message),
                   ep.rank_inputs(partition(ei, n, 1), 0, dev))
                  for name, partition, propagate in kinds]
        cot_dev = torch.from_numpy(cot).to(dev)
        for fn in counters.values():
            build.reset(fn)
        outs = {}
        for name, prop, args in inputs:
            xs = torch.from_numpy(x).to(dev).requires_grad_(True)
            y = prop(xs, *args)
            (g,) = torch.autograd.grad((y * cot_dev).sum(), [xs])
            outs[name] = (y.detach(), g)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        errs = {}
        for name, (y, g) in outs.items():
            errs[name] = (
                max_err(y.cpu(), want.detach(), FWD_RTOL, FWD_ATOL,
                        f"{name} propagate"),
                grad_check([g.cpu()], [want_g], f"{name} propagate grad"))
        # one K3 (forward) and one K4 (backward) a propagate: world size
        # 1 is one hop of the ring
        expect_launches(launches, {"segment_sum_sorted": 2,
                                   "segment_broadcast": 2}, 1,
                        "edge-partition propagates")
        bench = ep.scaling_efficiency_bench(mesh)
        log(f"[edge-partition] NCCL world size 1 (distributed.initialize), "
            f"{n} nodes, {E} edges, d={d}, message tanh(x_i) + 2 x_j: "
            f"(forward, gradient) max abs err against the plain CPU "
            f"version {errs}; launches {launches}; "
            f"scaling_efficiency_bench {bench} ({card})")

        # K3 and K4 at the propagate's shapes, on its CSR-ordered messages
        recv_l, send_l, order, ptr = inputs[0][2]
        r_sorted = recv_l.long()[order]
        xd = torch.from_numpy(x).to(dev)
        msgs = message(xd[r_sorted], xd[send_l.long()[order]]).contiguous()
        zeros = torch.zeros(n, d, device=dev)
        ptr_l = ptr.long()
        err = max_err(k3.segment_sum_sorted(msgs, ptr),
                      k3.segment_sum_sorted_plain(msgs, ptr), FWD_RTOL,
                      FWD_ATOL, "segment_sum_sorted[propagate]")
        # read the rows and ptr, write the sums; one add an element
        t_b, by = bound(4 * (E * d + n * d + n + 1), E * d)
        rows = {
            f"segment_sum_sorted[propagate d={d}]": dict(
                source="gsn_tpu_torch/csrc/segment_sum.cu",
                replaces="gsn_tpu/ops/pallas/slab_combine.py:77",
                max_abs_err=err, bound_ms=t_b, bound_by=by,
                launches=launches["segment_sum_sorted"],
                path="edge-partition",
                **timed(lambda: k3.segment_sum_sorted(msgs, ptr),
                        lambda: k3.segment_sum_sorted_plain(msgs, ptr),
                        lambda: torch.index_add(zeros, 0, r_sorted, msgs),
                        also={"segment_reduce_ms":
                              lambda: torch.segment_reduce(
                                  msgs, "sum", offsets=ptr_l)})),
            f"segment_broadcast[propagate d={d}]": dict(
                source="gsn_tpu_torch/csrc/segment_broadcast.cu",
                replaces="gsn_tpu/ops/pallas/slab_pool.py:90",
                launches=launches["segment_broadcast"],
                path="edge-partition",
                **k4_timed_ptr(timed, cot_dev, ptr, E,
                               k4.segment_broadcast,
                               k4.segment_broadcast_plain)),
        }
        for name, row in rows.items():
            log_row("edge-partition", name, row)
        return rows
    finally:
        distributed.shutdown()


# phases 38-39: the README's IMDBBINARY command (gin)
IMDB_GRAPHS = 1000
IMDB_D = 64
IMDB_BATCH = 32


def imdb_argv(root, *extra):
    """README.md's IMDBBINARY command (``--model_name GSN_sparse
    --msg_kind gin``, local ``complete_graph`` k=5 counts) on the
    synthetic IMDB set under ``root``: fold 0, 2 epochs of 50 steps,
    JSONL logging, on the card."""
    argv = ["--seed", "0", "--dataset", "social",
            "--dataset_name", "IMDBBINARY", "--root_folder", root,
            "--cache_folder", os.path.join(root, "cache_imdb"),
            "--id_type", "complete_graph", "--induced", "False", "--k", "5",
            "--id_scope", "local", "--id_encoding", "one_hot_unique",
            "--id_embedding", "one_hot_encoder",
            "--model_name", "GSN_sparse", "--msg_kind", "gin",
            "--num_layers", "4", "--d_out", str(IMDB_D),
            "--final_projection", "True", "--readout", "mean",
            "--batch_size", str(IMDB_BATCH), "--num_epochs", "2",
            "--num_iters", "50", "--lr", "1e-3", "--decay_steps", "10",
            "--decay_rate", "0.5", "--mode", "train", "--fold_idx", "0",
            "--wandb", "False"]
    return argv + list(extra)


def gin_rows(timed, data, d, part, gen, floor):
    """K1 and K2 as the gin message runs them (identity, no A side, a
    zero b1) at width ``d`` over the batch's edges: a node part (B the
    rows, no Pe) or an edge part (a zero B, Pe the edge rows).  Each
    against its plain version (K1 at the f32 tolerances, K2's dH, a copy
    of g, bit for bit), timed beside one PyTorch call of the same
    function: for K1 the CSR receiver adjacency times B
    (``torch.sparse.mm``) for a node part and ``index_add`` of Pe for an
    edge part, for K2 ``index_select`` of g at the edges' receivers (the
    real edges' rows of dH); bounds from the bytes the function moves
    (B at the senders with edges, Pe at the real edges, every output
    row; K2: g at the receivers with edges and every dH slot).  Returns
    the (fwd, bwd) rows."""
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    dev = data.x.device
    N, E, e_real = data.num_node_slots, data.num_edge_slots, \
        data.num_real_edges
    seg = edge_segments(data)
    rp, send = seg.recv_ptr, seg.send
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    if part == "node":
        B, Pe = torch.randn(N, d, device=dev, generator=gen), None
    else:
        B = torch.zeros(N, d, device=dev)
        Pe = torch.randn(E, d, device=dev, generator=gen)
    b1 = torch.zeros(d, device=dev)
    g = torch.randn(N, d, device=dev, generator=gen)
    tag = f"gin {part} f32 d={d}"
    want = k12.edge_message_fwd_plain(None, B, Pe, b1, rp, send, "identity")
    err_f = max_err(k12.edge_message_fwd(None, B, Pe, b1, rp, send,
                                         "identity"),
                    want, FWD_RTOL, FWD_ATOL, f"edge_message_fwd[{tag}]")
    dH, dA = k12.edge_message_bwd_recv(None, B, Pe, b1, g, rp, send,
                                       "identity", E)
    dH_p, _ = k12.edge_message_bwd_recv_plain(None, B, Pe, b1, g, rp, send,
                                              "identity", E)
    exact(dH, dH_p, f"edge_message_bwd_recv[{tag}] dH")
    if dA is not None:
        raise AssertionError("gin K2 returned dA with no A side")
    recv_l = k12.receivers(rp)
    if part == "node":
        adj = torch.sparse_csr_tensor(
            rp, send[:e_real], torch.ones(e_real, device=dev), size=(N, N))

        def library():
            return torch.sparse.mm(adj, B)
    else:
        zeros_nd = torch.zeros(N, d, device=dev)
        pe_real = Pe[:e_real]

        def library():
            return torch.index_add(zeros_nd, 0, recv_l, pe_real)
    max_err(library(), want, FWD_RTOL, FWD_ATOL, f"library [{tag}]")
    exact(torch.index_select(g, 0, recv_l), dH_p[:e_real],
          f"library index_select [{tag}]")
    idx = 4 * (d + N + 1 + e_real)
    fwd_b = bound(4 * (n_send * d + N * d
                       + (e_real * d if Pe is not None else 0)) + idx,
                  (2 + (Pe is not None)) * e_real * d)
    bwd_b = bound(4 * (n_recv * d + E * d) + 4 * (N + 1 + e_real), 0)
    fwd = timed(lambda: k12.edge_message_fwd(None, B, Pe, b1, rp, send,
                                             "identity"),
                lambda: k12.edge_message_fwd_plain(None, B, Pe, b1, rp, send,
                                                   "identity"), library)
    bwd = timed(lambda: k12.edge_message_bwd_recv(None, B, Pe, b1, g, rp,
                                                  send, "identity", E),
                lambda: k12.edge_message_bwd_recv_plain(
                    None, B, Pe, b1, g, rp, send, "identity", E),
                lambda: torch.index_select(g, 0, recv_l))
    src = "gsn_tpu_torch/csrc/edge_message.cu"
    out = []
    for row, (t_b, by), err, line in ((fwd, fwd_b, err_f, "214"),
                                      (bwd, bwd_b, 0.0, "240")):
        out.append(dict(source=src,
                        replaces=f"gsn_tpu/ops/pallas/slab_message.py:{line}",
                        max_abs_err=err, bound_ms=t_b, bound_by=by,
                        floor_ms=floor[0], blocks=floor[1], **row))
    return out


def card_vs_cpu(cfg, batch, loss_fn, what, seed=1):
    """A model of ``cfg`` (weights from ``seed``) on the card against the
    same on the CPU, in train mode on ``batch``: the prediction at the
    f32 tolerances and every gradient at the gradient tolerance; returns
    the max abs error."""
    from gsn_tpu_torch.nn.models import build_model
    ref = build_model(cfg, torch.Generator().manual_seed(seed))
    preds, grads = {}, {}
    for where in ("cpu", "cuda"):
        m = build_model(cfg)
        m.load_state_dict(ref.state_dict())
        m = m.to(where).train()
        b = batch.to(where)
        y_hat = m(b)
        loss_fn(y_hat, b.y, b.graph_mask).backward()
        preds[where] = y_hat.detach().cpu()
        grads[where] = [p.grad.detach().cpu() for p in m.parameters()]
    err = max_err(preds["cuda"], preds["cpu"], FWD_RTOL, FWD_ATOL,
                  f"{what} prediction (card vs CPU)")
    return max(err, grad_check(grads["cuda"], grads["cpu"],
                               f"{what} gradients (card vs CPU)"))


def expect_cli_launches(tag, got, per_train, per_eval, n_train, n_eval):
    """``got`` (launches by kernel and key) must be exactly ``per_train``
    a train step times ``n_train`` plus ``per_eval`` an eval step times
    ``n_eval``."""
    want = {}
    for per, n in ((per_train, n_train), (per_eval, n_eval)):
        for k, ms in per.items():
            for m, c in ms.items():
                want.setdefault(k, {}).setdefault(m, 0)
                want[k][m] += c * n
    got = {k: {m: c for m, c in v.items() if c} for k, v in got.items()}
    got = {k: v for k, v in got.items() if v}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want} "
                             f"({n_train} train and {n_eval} eval steps)")


def gin_phases(dev, card, timed, cpm, empty, root):
    """Phases 38-39 (see module docstring), their data written under
    ``root``; returns the gin path's kernel rows."""
    from gsn_tpu_torch import cli
    from gsn_tpu_torch.data.synthetic import write_imdb_dataset
    from gsn_tpu_torch.graphs.batching import iterate_batches
    from gsn_tpu_torch.train.metrics import cross_entropy_loss
    from gsn_tpu_torch.train.profiling import step_stats

    # ---- phase 38: the data, and K1/K2 at the gin path's shapes ----------
    t0 = time.perf_counter()
    write_imdb_dataset(root, IMDB_GRAPHS, seed=0)
    wrote = time.perf_counter() - t0
    args = vars(cli.build_parser().parse_args(imdb_argv(root)))
    times = []
    for _ in range(2):   # cold (counting), then from the cache
        t0 = time.perf_counter()
        graphs, cfg = cli.prepare(args)
        times.append(time.perf_counter() - t0)
    train, test, _val = cli.fold_splits(args, graphs, 0)
    n_nodes = [g["x"].shape[0] for g in graphs]
    n_edges = [g["edge_index"].shape[1] // 2 for g in graphs]
    d_x = graphs[0]["x"].shape[1]
    d_id = sum(cfg.d_in_id)
    trainer = cli.Trainer(cfg, cli.trainer_config(args), train)
    data = trainer._eval_batches(train, 1)[0].to(dev)
    N, E = data.num_node_slots, data.num_edge_slots
    log(f"[imdb-gin] data: {len(graphs)} ego-networks written in "
        f"{wrote:.3f} s ({np.mean(n_nodes):.2f} nodes, "
        f"{np.mean(n_edges):.2f} undirected edges a graph on average, "
        f"{min(n_nodes)}-{max(n_nodes)} nodes); prepare (complete_graph "
        f"k=5 local counts, one process, and the encoding) cold "
        f"{times[0]:.3f} s, from its cache {times[1]:.3f} s; x width "
        f"{d_x}, id vocabulary {cfg.d_in_id} (one-hot {d_id}, {d_id + 1} "
        f"with the central column); fold 0: {len(train)} train, "
        f"{len(test)} test; one train batch of {IMDB_BATCH} graphs: nodes "
        f"{int(data.node_mask.sum())}/{N}, edges {data.num_real_edges}/{E}")
    if d_x != 1:
        raise AssertionError(f"IMDB x width {d_x}, expected one node tag")
    gen = torch.Generator(device=dev).manual_seed(38)
    floor = (launch_floor_ms(empty, cpm, k1_blocks(N)), k1_blocks(N))
    widths = {"x": d_x, "ids": d_id + 1, "hidden": IMDB_D}
    # on the path: K1 on layer 0's node part (x) and edge part (ids), and
    # on layers 1-3's node part; K2 on layers 1-3 only (layer 0's parts
    # take no gradient: x is the input, the ids are one-hot constants)
    on_path = {("fwd", "node", d_x), ("fwd", "edge", d_id + 1),
               ("fwd", "node", IMDB_D), ("bwd", "node", IMDB_D)}
    rows, logged = {}, 0
    for d in sorted(set(widths.values())):
        for part in ("node", "edge"):
            fwd, bwd = gin_rows(timed, data, d, part, gen, floor)
            for kind, name, row in (("fwd", "edge_message_fwd", fwd),
                                    ("bwd", "edge_message_bwd_recv", bwd)):
                key = f"{name}[gin {part} f32 d={d}]"
                if (kind, part, d) in on_path:
                    rows[key] = row
                else:
                    log_row("imdb-gin", key, row)
                    logged += 1
    log(f"[imdb-gin] K1/K2 identity at d in {widths} (node and edge "
        f"parts): {len(rows)} rows on the path, {logged} on log lines")

    # ---- phase 39: the README's IMDBBINARY command through cli.main -------
    small_cfg = dataclasses.replace(cfg, num_layers=2, d_out=16)
    small = next(iterate_batches(train[:16], 16))
    err = card_vs_cpu(small_cfg, small, cross_entropy_loss, "small gin")
    log(f"[imdb-gin] small gin model (d=16, 2 layers) on the card vs the "
        f"CPU: max abs err {err}")
    from gsn_tpu_torch.ops.cuda import build
    counters = kernel_counters()
    for fn in counters.values():
        build.reset(fn)
    t0 = time.perf_counter()
    hist = run_cli(imdb_argv(root))[0]
    wall = time.perf_counter() - t0
    modes = {n: dict(fn.modes) for n, fn in counters.items()}
    k12w = {n: dict(counters[n].widths)
            for n in ("edge_message_fwd", "edge_message_bwd_recv")}
    k3_forms = dict(counters["segment_sum_sorted"].forms)
    for key, vals in hist.items():
        if vals and not np.isfinite(vals).all():
            raise AssertionError(f"imdb-gin: history {key} = {vals}")
    if len(hist["train_losses"]) != 2:
        raise AssertionError(f"imdb-gin: {hist}")
    L = 4
    n_train = 2 * 50
    n_eval = 2 * (-(-len(train) // IMDB_BATCH) + -(-len(test) // IMDB_BATCH))
    # a train step: K1 5 (layer 0's two parts, one part a layer after),
    # K2 3 and K3 dB 3 (layers 1-3), K3 5 pools (every layer's rows and
    # the input's, mean readout), K4 4 (the pools' backward but the
    # input's); an eval step: K1 5, K3 5
    expect_cli_launches(
        "imdb-gin", modes,
        {"edge_message_fwd": {"f32": L + 1},
         "edge_message_bwd_recv": {"f32": L - 1},
         "segment_sum_sorted": {"f32->f32": (L - 1) + (L + 1)},
         "segment_broadcast": {"f32": L}},
        {"edge_message_fwd": {"f32": L + 1},
         "segment_sum_sorted": {"f32->f32": L + 1}}, n_train, n_eval)
    expect_cli_launches(
        "imdb-gin K1/K2 by width", k12w,
        {"edge_message_fwd": {("f32", d_x): 1, ("f32", d_id + 1): 1,
                              ("f32", IMDB_D): L - 1},
         "edge_message_bwd_recv": {("f32", IMDB_D): L - 1}},
        {"edge_message_fwd": {("f32", d_x): 1, ("f32", d_id + 1): 1,
                              ("f32", IMDB_D): L - 1}}, n_train, n_eval)
    for key, row in rows.items():
        name, rest = key.split("[")
        d = int(rest.rstrip("]").split("d=")[1])
        row.update(launches=k12w[name][("f32", d)], path="imdb-gin")
    log(f"[imdb-gin] cli.main {wall:.3f} s: 2 epochs of 50 train steps "
        f"and {n_eval // 2} eval steps each; launches by mode {modes}; "
        f"K1/K2 by width {k12w}; K3 by form {k3_forms}")
    _d, recs = read_log(args, fold=0)
    for r in (r for r in recs if "train_loss" in r):
        log(f"[imdb-gin] epoch {r['step']}: train {r['train_loss']:.6f} "
            f"acc {r['train_acc']:.4f} test {r['test_loss']:.6f} acc "
            f"{r['test_acc']:.4f} lr {r['lr']}; epoch {r['epoch_s']:.4f} s "
            f"({r['steps']} steps, median step "
            f"{r['step_median_s'] * 1e3:.3f} ms, host batching "
            f"{r['host_batch_s'] / r['epoch_s']:.4f} of the epoch); "
            f"evaluation {r['eval_s']:.4f} s ({card})")
    state = trainer.init_state(seed=0)
    state, losses, step_s, launches, _ = train_steps(
        trainer, state, data, STEPS, counters)
    med = statistics.median(step_s[1:])
    log(f"[imdb-gin] {STEPS} steps on one batch: median "
        f"{med * 1e3:.3f} ms, {data.num_real_edges / med:.4e} real "
        f"edges/s, losses {losses[0]:.5f} -> {losses[-1]:.5f} ({card})")
    profile_steps(trainer, state, data, med * 1e3, "imdb-gin")
    stats = step_stats(lambda: trainer.train_step(state, data)[1],
                       num_edges=data.num_real_edges)
    log(f"[imdb-gin] step_stats (train/profiling.py; utilisation of the "
        f"H100 SXM f32 peak, 67 TFLOP/s): {stats} ({card})")
    return rows


def dgn_fused_rows(timed, data, aggs, d, tag):
    """K5/K6 ``<fused>`` (B8) at width ``d`` on ``data``'s edges, with the
    weight columns ``build_agg_ctx`` gives ``aggs`` and node rows after
    relu (about half zeros, so maxima tie): the forward's sums, maxima
    and tie counts and the backward (with and without dW) against their
    plain versions, timed with bounds as phase 8's.  Returns the (fwd,
    bwd) rows."""
    from gsn_tpu_torch.nn.dgn import build_agg_ctx
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_weighted as b58
    dev = data.x.device
    N, e_real = data.num_node_slots, data.num_real_edges
    seg = edge_segments(data)
    rp, send = seg.recv_ptr, seg.send
    W = build_agg_ctx(aggs, data, N).W
    K = W.shape[1]
    gen = torch.Generator(device=dev).manual_seed(40)
    B = torch.relu(torch.randn(N, d, device=dev, generator=gen))
    g_w = torch.randn(N, K * d, device=dev, generator=gen)
    g_mm = torch.randn(N, 2 * d, device=dev, generator=gen)
    out, mm, cnt = b58.dgn_fused_fwd(B, W, rp, send)
    out_p, mm_p, cnt_p = b58.dgn_fused_fwd_plain(B, W, rp, send)
    err_f = max(max_err(out, out_p, FWD_RTOL, FWD_ATOL, f"{tag} fwd out"),
                max_err(mm, mm_p, FWD_RTOL, FWD_ATOL, f"{tag} fwd mm"))
    exact(cnt, cnt_p, f"{tag} tie counts")
    err_b = 0.0
    for need_dw in (False, True):
        got = b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm, rp, send, need_dw)
        want = b58.dgn_fused_bwd_plain(B, W, g_w, mm_p, cnt_p, g_mm, rp,
                                       send, need_dw)
        err_b = max(err_b, grad_check(got[:1 + need_dw], want[:1 + need_dw],
                                      f"{tag} bwd[dW={need_dw}]"))
    n_recv = int((rp.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    f32 = 4
    walk = f32 * (n_send * d + N + 1 + e_real)
    kd, mm_w = K * d, 2 * d
    fwd_b = bound(walk + f32 * (e_real * K + N * kd + 2 * N * mm_w),
                  (2 * K + 2) * d * e_real)
    bwd_b = bound(walk + f32 * (e_real * K + n_recv * (kd + 3 * mm_w)
                                + e_real * d), (2 * K + 4) * d * e_real)
    src = "gsn_tpu_torch/csrc/dgn_aggregate.cu"
    fwd = dict(source=src, replaces="gsn_tpu/ops/pallas/slab_weighted.py:294",
               folds="gsn_tpu/ops/pallas/slab_combine.py:119",
               max_abs_err=err_f, bound_ms=fwd_b[0], bound_by=fwd_b[1], K=K,
               **timed(lambda: b58.dgn_fused_fwd(B, W, rp, send),
                       lambda: b58.dgn_fused_fwd_plain(B, W, rp, send)))
    bwd = dict(source=src, replaces="gsn_tpu/ops/pallas/slab_weighted.py:315",
               max_abs_err=err_b, bound_ms=bwd_b[0], bound_by=bwd_b[1], K=K,
               **timed(lambda: b58.dgn_fused_bwd(B, W, g_w, mm, cnt, g_mm,
                                                 rp, send),
                       lambda: b58.dgn_fused_bwd_plain(
                           B, W, g_w, mm_p, cnt_p, g_mm, rp, send)))
    return fwd, bwd


# phase 40: scripts/dgn_molhiv_10_runs.py's flags, verbatim, on a
# molhiv-like set of DGN_CLI_GRAPHS molecules split 80/10/10, 2 epochs
DGN_CLI_GRAPHS = 12000
DGN_CLI_D = 60


def dgn_cli_argv(root, *extra):
    flags = [
        "--weight_decay", "3e-6", "--L", "4", "--type_net", "simple",
        "--hidden_dim", "60", "--out_dim", "60", "--residual", "True",
        "--edge_feat", "False", "--readout", "mean",
        "--in_feat_dropout", "0.0", "--dropout", "0.3",
        "--graph_norm", "False", "--batch_norm", "True",
        "--aggregators", "mean max min dir0-av dir1-av dir2-av dir3-av",
        "--scalers", "identity", "--dataset", "ogbg-molhiv",
        "--epochs", "2", "--init_lr", "0.01",
        "--lr_reduce_factor", "0.5", "--lr_schedule_patience", "20",
        "--min_lr", "0.0001", "--id_scope", "local", "--k", "6",
        "--id_type", "cycle_graph", "--directions", "subgraphs",
        "--data_root", root, "--cache_folder",
        os.path.join(root, "cache_dgn"), "--seed", "1",
        "--print_epoch_interval", "1"]
    return flags + list(extra)


def dgn_cli_phase(dev, card, timed, root):
    """Phase 40 (see module docstring); returns its K5/K6 rows."""
    from gsn_tpu_torch import cli_directional as dcli
    from gsn_tpu_torch.data.synthetic import write_molhiv_dataset
    from gsn_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    write_molhiv_dataset(root, DGN_CLI_GRAPHS, seed=0)
    wrote = time.perf_counter() - t0
    argv = dgn_cli_argv(root)
    args = vars(dcli.build_parser().parse_args(argv))
    t0 = time.perf_counter()
    train, val, test, _tasks = dcli.prepare(dict(args))
    prep = time.perf_counter() - t0
    log(f"[dgn-cli] data: {DGN_CLI_GRAPHS} molecules written in "
        f"{wrote:.3f} s; prepare (cycle_graph k=6 local counts, "
        f"{args['num_processes']} threads, encoding, vector fields) cold "
        f"{prep:.3f} s; {len(train)} train, {len(val)} val, {len(test)} "
        f"test")
    counters = kernel_counters()
    for fn in counters.values():
        build.reset(fn)
    hist = []
    t0 = time.perf_counter()
    best = dcli.main(dict(args), history=hist)
    wall = time.perf_counter() - t0
    if best is None or not np.isfinite(best[1:]).all():
        raise AssertionError(f"dgn-cli: best-val {best}")
    launches = {n: fn.launches for n, fn in counters.items()}
    L = args["L"]
    n_train = 2 * -(-len(train) // args["batch_size"])
    n_eval = 2 * (-(-len(val) // args["batch_size"])
                  + -(-len(test) // args["batch_size"]))
    # a train step: K5/K6 fused L each, K3 L+2 (the node sums of
    # build_agg_ctx, the mean readout, each layer's dB), K4 1 (the
    # readout's backward); an eval step: K5 L, K3 2
    expect_cli_launches(
        "dgn-cli", {n: {"all": c} for n, c in launches.items()},
        {"dgn_fused_fwd": {"all": L}, "dgn_fused_bwd": {"all": L},
         "segment_sum_sorted": {"all": L + 2},
         "segment_broadcast": {"all": 1}},
        {"dgn_fused_fwd": {"all": L}, "segment_sum_sorted": {"all": 2}},
        n_train, n_eval)
    log(f"[dgn-cli] cli_directional.main {wall:.3f} s: best-val "
        f"(epoch, val ROC, test ROC) {best}; launches {launches} = "
        f"{n_train} train and {n_eval} eval steps")
    for r in hist:
        log(f"[dgn-cli] epoch {r['epoch']}: train loss {r['train_loss']:.6f}"
            f" val ROC {r['val_roc']:.4f} test ROC {r['test_roc']:.4f} lr "
            f"{r['lr']}; epoch {r['epoch_s']:.4f} s ({r['steps']} steps, "
            f"median step {r['step_median_s'] * 1e3:.3f} ms, host batching "
            f"{r['host_batch_s'] / r['epoch_s']:.4f} of the epoch) ({card})")
    # the path's trainer on one train batch: K5/K6 rows at its shapes,
    # then timed and profiled steps
    cfg = dcli.model_config(args, dcli.compute_avg_d(train), 1)
    trainer = dcli.Trainer(cfg, dcli.trainer_config(args), train,
                           model=dcli.DGNNet(cfg))
    data = trainer._eval_batches(train, 1)[0].to(dev)
    fwd, bwd = dgn_fused_rows(timed, data, cfg.aggregators, DGN_CLI_D,
                              "dgn-cli dgn_fused")
    K = fwd["K"]
    rows = {}
    for name, row in ((f"dgn_fused_fwd[d={DGN_CLI_D} K={K}]", fwd),
                      (f"dgn_fused_bwd[d={DGN_CLI_D} K={K}]", bwd)):
        row.update(launches=launches[name.split("[")[0]], path="dgn-cli")
        rows[name] = row
    state = trainer.init_state(seed=1)
    state, losses, step_s, _l, _m = train_steps(trainer, state, data, STEPS,
                                                counters)
    med = statistics.median(step_s[1:])
    log(f"[dgn-cli] one batch of {args['batch_size']} graphs (nodes "
        f"{int(data.node_mask.sum())}/{data.num_node_slots}, edges "
        f"{data.num_real_edges}/{data.num_edge_slots}, K={K}): {STEPS} "
        f"steps, median {med * 1e3:.3f} ms, "
        f"{data.num_real_edges / med:.4e} real edges/s ({card})")
    profile_steps(trainer, state, data, med * 1e3, "dgn-cli")

    # --parallel dp on one spawned NCCL rank against the serial run
    par_hist = []
    t0 = time.perf_counter()
    best_p = dcli.main(dict(vars(dcli.build_parser().parse_args(
        dgn_cli_argv(root, "--epochs", "1", "--parallel", "dp",
                     "--parallel_devices", "1")))), history=par_hist)
    wall = time.perf_counter() - t0
    got, want = par_hist[0]["train_loss"], hist[0]["train_loss"]
    rel = abs(got - want) / abs(want)
    if best_p is None or rel > CLI_PARALLEL_RTOL:
        raise AssertionError(f"dgn-cli --parallel dp: first epoch's train "
                             f"loss {got}, the serial run's {want}")
    log(f"[dgn-cli-dp] --parallel dp --parallel_devices 1: one epoch in "
        f"{wall:.3f} s (one spawned NCCL rank); train loss {got}, the "
        f"serial first epoch {want} (rel {rel:.3e}, bit for bit "
        f"{got == want}; rank 0 draws the serial trainer's dropout "
        f"stream, and its BN and loss sums run over one rank); best-val "
        f"{best_p}")
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gsn_tpu_torch.graphs.batching import iterate_batches
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import build
    from gsn_tpu_torch.ops.cuda import slab_combine as k3
    from gsn_tpu_torch.ops.cuda import slab_message as k12
    from gsn_tpu_torch.ops.cuda import slab_pool as k4
    from gsn_tpu_torch.train.loop import Trainer, full_f32_matmuls
    from gsn_tpu_torch.train.metrics import l1_loss

    dev = torch.device("cuda")
    # ---- phase 1: card, precision, build ---------------------------------
    card = card_line()
    log(f"[smoke] card: {card}")
    full_f32_matmuls()
    probe = start_launch_probe()
    secs = build.build_all()
    empty = load_launch_probe(probe)
    log(f"[smoke] built {len(build.SIGNATURES)} kernel libraries in "
        f"{secs:.1f} s")
    for name, text in build.build_logs.items():
        print(f"[nvcc {name}]\n{text}", file=sys.stderr)

    # ---- phase 2: the main path's batch ----------------------------------
    t0 = time.perf_counter()
    graphs, host_batch, data, cfg, tcfg = zinc_setup(dev)
    N, E, G = (data.num_node_slots, data.num_edge_slots,
               data.num_graph_slots)
    e_real = data.num_real_edges
    n_real = int(host_batch.node_mask.sum())
    log(f"[smoke] data {time.perf_counter() - t0:.1f} s: nodes {n_real}/{N}"
        f", edges {e_real}/{E}, graphs {G}, id vocab {cfg.d_in_id}")

    # ---- phase 3: each kernel against its plain version ------------------
    seg = edge_segments(data)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    A, B, Pe, b1 = rnd(N, D), rnd(N, D), rnd(E, D), rnd(D)
    g_node, g_graph = rnd(N, D), rnd(G, D)
    recv_ptr, send = seg.recv_ptr, seg.send
    # rows the functions must touch: receivers and senders with at least
    # one edge, graphs with at least one node
    n_recv = int((recv_ptr.diff() > 0).sum())
    n_send = int((seg.send_ptr.diff() > 0).sum())
    n_dst = seg.send_ptr.numel() - 1
    g_full = int((data.graph_ptr.diff() > 0).sum())
    log(f"[smoke] rows with edges: receivers {n_recv}, senders {n_send}; "
        f"graphs with nodes {g_full}")
    rows = {}
    cpm = spin_cycles_per_ms()

    def timed(kernel, plain, library=None, fill=None, also=None):
        ms, host_ms = time_ms(kernel, cpm)
        row = dict(ms=ms, host_ms=host_ms,
                   plain_ms=time_ms(plain, cpm, guard=False)[0],
                   library_ms=time_ms(library, cpm)[0] if library else None)
        if fill is not None:
            row["fill_ms"] = time_ms(fill, cpm)[0]
        for key, fn in (also or {}).items():   # more library calls
            row[key] = time_ms(fn, cpm)[0]
        return row

    # K1
    err = 0.0
    for act in ("relu", "identity"):
        err = max(err, max_err(
            k12.edge_message_fwd(A, B, Pe, b1, recv_ptr, send, act),
            k12.edge_message_fwd_plain(A, B, Pe, b1, recv_ptr, send, act),
            FWD_RTOL, FWD_ATOL, f"edge_message_fwd[{act}]"))
    # read A, B, Pe, b1, recv_ptr, send; write out
    t_b, by = bound(4 * ((n_recv + n_send + N) * D + e_real * D + D
                         + N + 1 + e_real), 5 * e_real * D)
    rows["edge_message_fwd"] = dict(
        source="gsn_tpu_torch/csrc/edge_message.cu",
        replaces="gsn_tpu/ops/pallas/slab_message.py:214",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k12.edge_message_fwd(A, B, Pe, b1, recv_ptr, send,
                                             "relu"),
                lambda: k12.edge_message_fwd_plain(A, B, Pe, b1, recv_ptr,
                                                   send, "relu")))

    # K2
    err = 0.0
    for act in ("relu", "identity"):
        dH, dA = k12.edge_message_bwd_recv(A, B, Pe, b1, g_node, recv_ptr,
                                           send, act, E)
        dH_p, dA_p = k12.edge_message_bwd_recv_plain(
            A, B, Pe, b1, g_node, recv_ptr, send, act, E)
        err = max(err, max_err(dH, dH_p, FWD_RTOL, FWD_ATOL,
                               f"edge_message_bwd_recv[{act}] dH"),
                  max_err(dA, dA_p, FWD_RTOL, FWD_ATOL,
                          f"edge_message_bwd_recv[{act}] dA"))
    # read A, g, B, Pe, b1, recv_ptr, send; write dA and dH (every slot)
    t_b, by = bound(4 * ((2 * n_recv + n_send + N) * D + e_real * D
                         + E * D + D + N + 1 + e_real), 5 * e_real * D)
    rows["edge_message_bwd_recv"] = dict(
        source="gsn_tpu_torch/csrc/edge_message.cu",
        replaces="gsn_tpu/ops/pallas/slab_message.py:240",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k12.edge_message_bwd_recv(
                    A, B, Pe, b1, g_node, recv_ptr, send, "relu", E),
                lambda: k12.edge_message_bwd_recv_plain(
                    A, B, Pe, b1, g_node, recv_ptr, send, "relu", E)))

    # K3: the sender-side dB (its row in the JSON line) and the graph
    # readout (checked, and timed on a log line of its own)
    dH_real = dH[:e_real]
    err = max_err(k3.segment_sum_sorted(dH, seg.send_ptr, seg.send_perm),
                  k3.segment_sum_sorted_plain(dH, seg.send_ptr,
                                              seg.send_perm),
                  FWD_RTOL, FWD_ATOL, "segment_sum_sorted[send]")
    err = max(err, max_err(
        k3.segment_sum_sorted(A, data.graph_ptr),
        k3.segment_sum_sorted_plain(A, data.graph_ptr),
        FWD_RTOL, FWD_ATOL, "segment_sum_sorted[pool]"))
    zeros_nd = torch.zeros(N, D, device=dev)
    send_l = send[:e_real].long()
    t_b, by = bound(4 * (e_real * D + n_dst * D + n_dst + 1 + e_real),
                    e_real * D)
    rows["segment_sum_sorted"] = dict(
        source="gsn_tpu_torch/csrc/segment_sum.cu",
        replaces="gsn_tpu/ops/pallas/slab_combine.py:77",
        max_abs_err=err, bound_ms=t_b, bound_by=by,
        **timed(lambda: k3.segment_sum_sorted(dH, seg.send_ptr,
                                              seg.send_perm),
                lambda: k3.segment_sum_sorted_plain(dH, seg.send_ptr,
                                                    seg.send_perm),
                lambda: torch.index_add(zeros_nd, 0, send_l, dH_real)))
    zeros_gd = torch.zeros(G, D, device=dev)
    batch_l = data.batch[:n_real].long()
    pool_b, _ = bound(4 * (n_real * D + G * D + G + 1), n_real * D)
    gp_l = data.graph_ptr.long()
    pool = timed(lambda: k3.segment_sum_sorted(A, data.graph_ptr),
                 lambda: k3.segment_sum_sorted_plain(A, data.graph_ptr),
                 lambda: torch.index_add(zeros_gd, 0, batch_l, A[:n_real]),
                 also={"segment_reduce_ms": lambda: torch.segment_reduce(
                     A[:n_real], "sum", offsets=gp_l)})
    log("[smoke] segment_sum_sorted[pool] "
        + " ".join(f"{k} {v}" for k, v in pool.items())
        + f" bound_ms {pool_b}")

    # K4: the pool backward at d=128 (its row), then the stress shapes
    rows["segment_broadcast"] = dict(
        source="gsn_tpu_torch/csrc/segment_broadcast.cu",
        replaces="gsn_tpu/ops/pallas/slab_pool.py:90",
        **k4_timed(timed, data, g_graph, k4.segment_broadcast,
                   k4.segment_broadcast_plain))
    log(f"[k4] stress shapes ({', '.join(k4_layouts())}; d in "
        f"{K4_STRESS_D}; aligned g and an unaligned view; K4, AddPool and "
        f"GraphBroadcast): {k4_stress(dev)} cases equal their plain "
        f"versions bit for bit")
    log(k4_ptxas_line())

    # the autograd Functions' backward passes against autograd through
    # the plain versions
    leaves = [t.clone().requires_grad_(True) for t in (A, B, Pe, b1)]
    out = k12.edge_message_aggregate(*leaves, seg, "relu")
    got = torch.autograd.grad((out * g_node).sum(), leaves)
    ref_leaves = [t.clone().requires_grad_(True) for t in (A, B, Pe, b1)]
    out_p = k12.edge_message_fwd_plain(*ref_leaves, recv_ptr, send, "relu")
    want = torch.autograd.grad((out_p * g_node).sum(), ref_leaves)
    fn_err = grad_check(got, want, "EdgeMessageAggregate")
    x = A.clone().requires_grad_(True)
    got = torch.autograd.grad((k4.add_pool(x, data.graph_ptr)
                               * g_graph).sum(), [x])
    x_p = A.clone().requires_grad_(True)
    want = torch.autograd.grad((k3.segment_sum_sorted_plain(
        x_p, data.graph_ptr) * g_graph).sum(), [x_p])
    exact(got[0], want[0], "AddPool backward")
    log(f"[smoke] autograd backward max abs err {fn_err} (AddPool's "
        f"backward, K4, bit for bit)")
    torch.cuda.synchronize()

    # ---- phase 4: whole model, card vs CPU, on a small batch -------------
    small = next(iterate_batches(graphs[:64], 64, y_shape=(),
                                 y_dtype=np.float32))
    model_err = card_vs_cpu(cfg, small, l1_loss, "model")
    log(f"[smoke] model on the card vs the CPU: max abs err {model_err}")

    # ---- phase 5: the main path --------------------------------------------
    trainer = Trainer(cfg, tcfg, graphs)
    state = trainer.init_state(seed=0)
    counters = kernel_counters()
    L = cfg.num_layers
    per_step = {"edge_message_fwd": L, "edge_message_bwd_recv": L,
                "segment_sum_sorted": L + (L + 1),
                "segment_broadcast": L + 1}
    state, losses, step_s, launches, _ = train_steps(trainer, state, data,
                                                     STEPS, counters)
    log(f"[smoke] losses {losses}")
    log(f"[smoke] launches in {STEPS} steps: {launches}")
    expect_launches(launches, per_step, STEPS, "zinc path")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name in per_step:
        rows[name].update(launches=launches[name], path="zinc")
    med = statistics.median(step_s[1:])
    log(f"[smoke] train step median {med * 1e3:.3f} ms over {STEPS - 1} "
        f"steps (first {step_s[0] * 1e3:.1f} ms), "
        f"{e_real / med:.4e} real edges/s ({card})")

    profile_steps(trainer, state, data, med * 1e3, "zinc")

    dgn_rows, dgn = dgn_phases(dev, card, timed)
    rows.update(dgn_rows)
    molhiv_rows, molhiv = molhiv_phases(dev, card, timed)
    rows.update(molhiv_rows)
    zinc = (graphs, data, cfg, tcfg)
    rows.update(bf16_phases(dev, card, timed, zinc, molhiv))
    rows.update(dgn_bf16_phases(dev, card, timed, dgn))
    rows.update(fused_bn_phases(dev, card, timed, zinc))
    with tempfile.TemporaryDirectory() as root:
        cli_rows, cli_hist = cli_phases(dev, card, timed, cpm, empty, (G, N),
                                        root)
        rows.update(cli_rows)

        # ---- phase 33: K1, K2 and K3 across widths -------------------------
        log(f"[sweep] K1, K2 and K3 at d in {SWEEP_D}, segment lengths "
            f"{SWEEP_LENGTHS} and 300 of 0-4 rows: {width_sweep(dev)} "
            f"cases equal their plain versions")

        c3_phase(card, zinc, dgn)                                    # 34
        rows.update(split_mode_phase(dev, timed, host_batch, cpm,
                                     empty))                         # 35
        parallel_phase(card, zinc, host_batch, losses, rows, root)   # 36
        cli_parallel_phase(root, cli_hist)                           # 37
        rows.update(gin_phases(dev, card, timed, cpm, empty, root))  # 38-39
        rows.update(dgn_cli_phase(dev, card, timed, root))           # 40
        coordinator_cli_phase(card, root, cli_hist, rows)            # 41
        rows.update(edge_partition_phase(dev, card, timed))          # 42
        graphed_epochs_phase(card, root)                             # 43
        graphed_parallel_phase(card, root)                           # 44

    # kernel_ms and bound_us repeat ms and bound_ms in the units the
    # port's kernel table uses
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", **row, kernel_ms=row["ms"],
             bound_us=row["bound_ms"] * 1e3)
        for name, row in rows.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
