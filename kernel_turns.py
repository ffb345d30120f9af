#!/usr/bin/env python3
"""Compare two builds of one of the port's kernels on one card.

    python3 kernel_turns.py dgn OTHER_CSRC_DIR
    python3 kernel_turns.py k4 OTHER_CSRC_DIR
    python3 kernel_turns.py k3 OTHER_CSRC_DIR
    python3 kernel_turns.py k1 OTHER_CSRC_DIR
    python3 kernel_turns.py k2 OTHER_CSRC_DIR

Builds the kernel's source from ``OTHER_CSRC_DIR`` (another commit's
``gsn_tpu_torch/csrc``) beside this checkout's kernels:

- ``dgn``: K5/K6 (``dgn_aggregate.cu``), the six functions on them in
  the main path's forms, on the DGN batch and operands of
  ``chip_smoke.py`` phases 7-8, on f32 rows and (where both builds have
  the bf16 entry points) on bf16 rows; the path is
  ``bench.py::bench_dgn``'s configuration.
- ``k4``: K4 (``segment_broadcast.cu``) at its four shapes on the paths:
  zinc's pool backward (d=128), the DGN mean-pool backward (d=70), the
  molhiv virtual node's pool backward and B4's forward (d=300), each on
  its path's batch; the paths are the zinc and molhiv main paths.
- ``k3``: K3 (``segment_sum.cu``) at every shape the paths give it: dB
  and the pools of zinc (d=128, f32 and bf16) and of zinc-bf16-bnmlp
  (f32 -> bf16 dB), dB, the pool and B4's backward of molhiv (d=300,
  f32 and bf16), the DGN dB (d=70, f32 and bf16) and zinc-cli's message
  sum, pools and dB (d=150); each in the form ``segment_sum_form``
  picks.  The other build's K3 may predate the form argument: its calls
  then drop it.  The paths are zinc, zinc-bf16, zinc-bf16-bnmlp,
  molhiv, DGN and zinc-cli.
- ``k1``: K1 (``edge_message.cu``'s forward) in every mode the paths
  run: relu (and identity) at zinc's d=128 on f32 and bf16 data, id_sq
  at d=128 on both, the ogb form (no A) at molhiv's d=300, relu and
  id_sq at zinc-cli's d=150 on both, and the gin form (identity, no A,
  zero b1; a node part, or an edge part with a zero B) on an IMDB batch
  at the imdb-gin path's widths (1, 64 and the ids' 689); the paths are
  zinc, zinc-bf16, zinc-bf16-bnmlp, molhiv, zinc-cli-bf16 and
  imdb-gin.
- ``k2``: K2 (``edge_message.cu``'s backward) in every mode the paths
  run, each on its path's batch: relu at zinc's d=128 on f32 and bf16
  data, id_sq bf16 at d=128, the ogb form (relu, no A, Pe, zero b1) at
  molhiv's d=300 on f32 and bf16, relu and id_sq bf16 at zinc-cli's
  d=150, and the gin form as k1's; the paths are zinc, zinc-bf16,
  zinc-bf16-bnmlp, molhiv, molhiv-bf16, zinc-cli-bf16 and imdb-gin.

Then:

1. For each function, checks the two builds' outputs and times them
   with ``chip_smoke.time_ms`` in turns: other, this, this, other.  The
   bits must be equal, except for K3's block form, whose sums meet in
   another order: it is held to the f32 tolerances (rtol 2e-4 / atol
   2e-5) or, into bf16, one bf16 ulp.
2. For each path, trains STEPS steps from seed 0 with each build and
   prints both loss lists.
3. For each path, profiles PROFILE_STEPS steps with each build, in turns
   other, this, this, other: device busy ms a step and the kernel's
   share of it.
4. Compares the ptxas lines (registers, shared memory, spills) of the
   source's kernels that both builds compile under one name (for k1,
   K2, and for k2, K1, where the other kernel kept its code), and prints
   the new build's most registers and spill bytes over the kernel it
   compares.

Prints the card's name and power limit first and one JSON line last.
Needs one CUDA card; run from the repository root.
"""

import dataclasses
import functools
import json
import os
import sys
import tempfile

import torch

import chip_smoke as smoke

STEPS = 3
PROFILE_STEPS = 5
# mode -> (source under csrc/, the kernel's name in the log, the text
# its kernels' names hold in a profile)
MODES = {"dgn": ("dgn_aggregate", "K5/K6", "dgn_aggregate"),
         "k4": ("segment_broadcast", "K4", "segment_broadcast"),
         "k3": ("segment_sum", "K3", "segment_sum"),
         "k1": ("edge_message", "K1", "edge_message_fwd"),
         "k2": ("edge_message", "K2", "edge_message_bwd_recv")}


def outputs(x):
    return [t for t in (x if isinstance(x, tuple) else (x,))
            if t is not None]


def busy_ms(trainer, state, data, key):
    """(device busy ms a step, ms a step of the kernels whose names hold
    ``key``) over PROFILE_STEPS steps."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            state, _ = trainer.train_step(state, data)
        torch.cuda.synchronize()
    events = smoke.device_events(prof)
    busy = sum(us for us, _ in events)
    ours = sum(us for us, e in events if key in e.key)
    return busy / 1e3 / PROFILE_STEPS, ours / 1e3 / PROFILE_STEPS


def dgn_case(dev):
    """The dgn mode's (functions by name, paths by name: (a function
    making the path's trainer, its batch))."""
    from gsn_tpu_torch.nn.dgn import DGNNet
    from gsn_tpu_torch.ops.cuda import slab_minmax as b6
    from gsn_tpu_torch.train.loop import Trainer

    graphs, _, data = smoke.dgn_batch(dev)
    seg, W, B, g_w, g_mm = smoke.dgn_operands(dev, data)
    fns = {}
    for tag, dtype in (("", torch.float32), ("[bf16]", torch.bfloat16)):
        Bt, g_wt = B.to(dtype), g_w.to(dtype)
        mm, cnt = b6.segment_minmax_fwd_plain(Bt, seg.recv_ptr, seg.send)
        fns.update({name + tag: fn for name, (fn, _) in
                    smoke.dgn_kernel_calls(Bt, W, g_wt, mm, cnt, g_mm,
                                           seg).items()})
    cfg, tcfg = smoke.dgn_main_config(graphs)
    return fns, {"dgn": (lambda: Trainer(cfg, tcfg, graphs,
                                         model=DGNNet(cfg)), data)}


def k4_case(dev):
    """The k4 mode's (functions by name, paths by name), as
    ``dgn_case``."""
    from gsn_tpu_torch.ops.cuda import slab_pool as k4

    zinc = smoke.zinc_setup(dev)
    dgn_data = smoke.dgn_batch(dev)[2]
    molhiv = smoke.molhiv_setup(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def call(fn, data, d):
        g = torch.randn(data.num_graph_slots, d, device=dev, generator=gen)
        return lambda: fn(g, data.graph_ptr, data.num_node_slots)

    fns = {
        f"zinc pool backward d={smoke.D}": call(
            k4.segment_broadcast, zinc[2], smoke.D),
        f"dgn mean-pool backward d={smoke.DGN_D}": call(
            k4.segment_broadcast, dgn_data, smoke.DGN_D),
        f"molhiv pool backward d={smoke.MOLHIV_D}": call(
            k4.segment_broadcast, molhiv[2], smoke.MOLHIV_D),
        f"molhiv B4 forward d={smoke.MOLHIV_D}": call(
            k4.graph_broadcast, molhiv[2], smoke.MOLHIV_D),
    }
    return fns, {path: path_of(setup) for path, setup in (
        ("zinc", zinc), ("molhiv", molhiv))}


def path_of(setup, **over):
    """(a function making the trainer of ``chip_smoke``'s path
    ``setup``, with the config fields ``over``, its batch)."""
    from gsn_tpu_torch.train.loop import Trainer
    graphs, _, data, cfg, tcfg = setup
    cfg = dataclasses.replace(cfg, **over)
    return functools.partial(Trainer, cfg, tcfg, graphs), data


def zinc_cli_path(dev, root, *extra):
    """(a function making zinc-cli's trainer (``chip_smoke.zinc_cli_argv``
    + ``extra``) on the synthetic ZINC set under ``root``, its first
    train batch)."""
    from gsn_tpu_torch import cli
    args = vars(cli.build_parser().parse_args(
        smoke.zinc_cli_argv(root, *extra)))
    make, _, data = smoke.zinc_cli_trainer(args, dev)
    return make, data


def imdb_gin_path(dev, root):
    """(a function making the imdb-gin path's trainer
    (``chip_smoke.imdb_argv``) on the synthetic IMDB set it writes under
    ``root``, its first train batch, the gin forms' widths)."""
    from gsn_tpu_torch import cli
    from gsn_tpu_torch.data.synthetic import write_imdb_dataset
    write_imdb_dataset(root, smoke.IMDB_GRAPHS, seed=0)
    args = vars(cli.build_parser().parse_args(smoke.imdb_argv(root)))
    graphs, cfg = cli.prepare(args)
    train = cli.fold_splits(args, graphs, 0)[0]
    tcfg = cli.trainer_config(args)

    def make():
        return cli.Trainer(cfg, tcfg, train)

    data = make()._eval_batches(train, 1)[0].to(dev)
    widths = (graphs[0]["x"].shape[1], smoke.IMDB_D, sum(cfg.d_in_id) + 1)
    return (make, data), widths


def gin_operands(data, d, part, gen):
    """The gin form's (B, Pe, b1, g) at width ``d``: a node part (B
    the rows, no Pe) or an edge part (a zero B, Pe the rows), zero b1."""
    dev = data.x.device
    N, E = data.num_node_slots, data.num_edge_slots
    if part == "node":
        B, Pe = torch.randn(N, d, device=dev, generator=gen), None
    else:
        B = torch.zeros(N, d, device=dev)
        Pe = torch.randn(E, d, device=dev, generator=gen)
    g = torch.randn(N, d, device=dev, generator=gen)
    return B, Pe, torch.zeros(d, device=dev), g


def k3_case(dev, root):
    """The k3 mode's (functions by name: (call, whether its bits must
    equal the other build's), paths by name); ``root`` takes zinc-cli's
    synthetic data."""
    from gsn_tpu_torch.data.synthetic import write_zinc_dataset
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_combine as k3

    gen = torch.Generator(device=dev).manual_seed(3)
    f32, bf = torch.float32, torch.bfloat16
    fns = {}

    def add(name, n_rows, d, ptr, perm=None, t_in=f32, t_out=f32):
        rows = torch.randn(n_rows, d, device=dev, generator=gen).to(t_in)
        form = k3.segment_sum_form(
            ptr.numel() - 1, perm.numel() if perm is not None else n_rows)
        fns[f"{name} {smoke.dtype_tag(t_in)}->{smoke.dtype_tag(t_out)} "
            f"d={d} [{form}]"] = (
            lambda: k3.segment_sum_sorted(rows, ptr, perm, t_out),
            form == "warp")

    def db_and_pool(tag, data, d, modes):
        seg = edge_segments(data)
        for t_in, t_out in modes:
            add(f"{tag} dB", data.num_edge_slots, d, seg.send_ptr,
                seg.send_perm, t_in, t_out)
        for t_in in {t for t, _ in modes}:
            add(f"{tag} pool", data.num_node_slots, d, data.graph_ptr,
                t_in=t_in)

    zinc = smoke.zinc_setup(dev)
    db_and_pool("zinc", zinc[2], smoke.D, ((f32, f32), (bf, bf), (f32, bf)))
    molhiv = smoke.molhiv_setup(dev)
    db_and_pool("molhiv", molhiv[2], smoke.MOLHIV_D, ((f32, f32), (bf, bf)))
    for t in (f32, bf):   # B4's backward: vn's cotangent, into vn's dtype
        add("molhiv B4 backward", molhiv[2].num_node_slots, smoke.MOLHIV_D,
            molhiv[2].graph_ptr, t_in=t, t_out=t)
    dgn_graphs, _, dgn_data = smoke.dgn_batch(dev)
    dgn_seg = edge_segments(dgn_data)
    for t in (f32, bf):
        add("dgn dB", dgn_data.num_edge_slots, smoke.DGN_D,
            dgn_seg.send_ptr, dgn_seg.send_perm, t, t)
    write_zinc_dataset(root, smoke.ZINC_SIZES, seed=0)
    cli = zinc_cli_path(dev, root)
    data = cli[1]
    add("zinc-cli message sum", data.num_edge_slots, smoke.CLI_D,
        data.recv_ptr)
    db_and_pool("zinc-cli", data, smoke.CLI_D, ((bf, bf), (f32, bf)))
    add("zinc-cli pool", data.num_node_slots, smoke.CLI_D, data.graph_ptr)
    dgn_cfg, dgn_tcfg = smoke.dgn_main_config(dgn_graphs)
    from gsn_tpu_torch.nn.dgn import DGNNet
    from gsn_tpu_torch.train.loop import Trainer
    paths = {
        "zinc": path_of(zinc),
        "zinc-bf16": path_of(zinc, compute_dtype="bfloat16"),
        "zinc-bf16-bnmlp": path_of(zinc, compute_dtype="bfloat16",
                                   bn_mlp=True),
        "molhiv": path_of(molhiv),
        "dgn": (lambda: Trainer(dgn_cfg, dgn_tcfg, dgn_graphs,
                                model=DGNNet(dgn_cfg)), dgn_data),
        "zinc-cli": cli,
    }
    return fns, paths


def k1_case(dev, root):
    """The k1 mode's (functions by name: (call, True), paths by name),
    as ``k3_case``."""
    from gsn_tpu_torch.data.synthetic import write_zinc_dataset
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_message as k12

    gen = torch.Generator(device=dev).manual_seed(4)
    f32, bf = torch.float32, torch.bfloat16
    fns = {}

    def add(tag, data, d, dtype, act, has_a=True):
        seg = edge_segments(data)
        N, E = data.num_node_slots, data.num_edge_slots

        def rnd(*shape):
            return torch.randn(*shape, device=dev, generator=gen).to(dtype)

        A = rnd(N, d) if has_a else None
        B, Pe = rnd(N, d), rnd(E, d)
        b1 = (torch.randn(d, device=dev, generator=gen) if has_a
              else torch.zeros(d, device=dev))
        fns[f"{tag} {smoke.dtype_tag(dtype)} {act} d={d}"] = (
            lambda: k12.edge_message_fwd(A, B, Pe, b1, seg.recv_ptr,
                                         seg.send, act), True)

    zinc = smoke.zinc_setup(dev)
    for dtype in (f32, bf):
        for act in ("relu", "identity", "id_sq"):
            add("zinc", zinc[2], smoke.D, dtype, act)
    molhiv = smoke.molhiv_setup(dev)
    for dtype in (f32, bf):
        add("molhiv ogb", molhiv[2], smoke.MOLHIV_D, dtype, "relu", False)
    write_zinc_dataset(root, smoke.ZINC_SIZES, seed=0)
    cli = zinc_cli_path(dev, root, "--compute_dtype", "bfloat16")
    for dtype in (f32, bf):
        for act in ("relu", "id_sq"):
            add("zinc-cli", cli[1], smoke.CLI_D, dtype, act)
    imdb, widths = imdb_gin_path(dev, os.path.join(root, "imdb"))
    seg = edge_segments(imdb[1])
    for d in widths:
        for part in ("node", "edge"):
            B, Pe, b1, _g = gin_operands(imdb[1], d, part, gen)
            fns[f"imdb-gin {part} f32 identity d={d}"] = (
                functools.partial(k12.edge_message_fwd, None, B, Pe, b1,
                                  seg.recv_ptr, seg.send, "identity"), True)
    paths = {
        "zinc": path_of(zinc),
        "zinc-bf16": path_of(zinc, compute_dtype="bfloat16"),
        "zinc-bf16-bnmlp": path_of(zinc, compute_dtype="bfloat16",
                                   bn_mlp=True),
        "molhiv": path_of(molhiv),
        "zinc-cli-bf16": cli,
        "imdb-gin": imdb,
    }
    return fns, paths


def k2_case(dev, root):
    """The k2 mode's (functions by name: (call, True), paths by name),
    as ``k3_case``."""
    from gsn_tpu_torch.data.synthetic import write_zinc_dataset
    from gsn_tpu_torch.nn.models import edge_segments
    from gsn_tpu_torch.ops.cuda import slab_message as k12

    gen = torch.Generator(device=dev).manual_seed(5)
    f32, bf = torch.float32, torch.bfloat16
    fns = {}

    def add(tag, data, d, dtype, act, has_a=True):
        seg = edge_segments(data)
        N, E = data.num_node_slots, data.num_edge_slots

        def rnd(*shape):
            return torch.randn(*shape, device=dev, generator=gen)

        A = rnd(N, d).to(dtype) if has_a else None
        B, Pe = rnd(N, d).to(dtype), rnd(E, d).to(dtype)
        b1 = rnd(d) if has_a else torch.zeros(d, device=dev)
        g = rnd(N, 2 * d) if act == "id_sq" else rnd(N, d).to(dtype)
        fns[f"{tag} {smoke.dtype_tag(dtype)} {act} d={d}"] = (
            lambda: k12.edge_message_bwd_recv(A, B, Pe, b1, g, seg.recv_ptr,
                                              seg.send, act, E), True)

    zinc = smoke.zinc_setup(dev)
    add("zinc", zinc[2], smoke.D, f32, "relu")
    add("zinc", zinc[2], smoke.D, bf, "relu")
    add("zinc", zinc[2], smoke.D, bf, "id_sq")
    molhiv = smoke.molhiv_setup(dev)
    for dtype in (f32, bf):
        add("molhiv ogb", molhiv[2], smoke.MOLHIV_D, dtype, "relu", False)
    write_zinc_dataset(root, smoke.ZINC_SIZES, seed=0)
    cli = zinc_cli_path(dev, root, "--compute_dtype", "bfloat16")
    for act in ("relu", "id_sq"):
        add("zinc-cli", cli[1], smoke.CLI_D, bf, act)
    imdb, widths = imdb_gin_path(dev, os.path.join(root, "imdb"))
    seg = edge_segments(imdb[1])
    E = imdb[1].num_edge_slots
    for d in widths:
        for part in ("node", "edge"):
            B, Pe, b1, g = gin_operands(imdb[1], d, part, gen)
            fns[f"imdb-gin {part} f32 identity d={d}"] = (
                functools.partial(k12.edge_message_bwd_recv, None, B, Pe,
                                  b1, g, seg.recv_ptr, seg.send, "identity",
                                  E), True)
    paths = {
        "zinc": path_of(zinc),
        "zinc-bf16": path_of(zinc, compute_dtype="bfloat16"),
        "zinc-bf16-bnmlp": path_of(zinc, compute_dtype="bfloat16",
                                   bn_mlp=True),
        "molhiv": path_of(molhiv),
        "molhiv-bf16": path_of(molhiv, compute_dtype="bfloat16"),
        "zinc-cli-bf16": cli,
        "imdb-gin": imdb,
    }
    return fns, paths


def same_or_close(got, want):
    """(equal bits, max abs err) of one build's outputs against the
    other's; a tolerance failure raises (chip_smoke's checks)."""
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = 0.0
    for a, b in zip(got, want):
        if a.dtype == torch.bfloat16:
            err = max(err, smoke.bf16_check(a, b, "the two builds"))
        else:
            err = max(err, smoke.max_err(a, b, smoke.FWD_RTOL,
                                         smoke.FWD_ATOL, "the two builds"))
    return same, err


class NoFormArgument:
    """Another build's K3 library whose entry points predate the form
    argument: calls drop it (the other build has one form)."""

    def __init__(self, lib):
        from gsn_tpu_torch.ops.cuda import build
        self._fns = {}
        for sym, argtypes in build.SIGNATURES["segment_sum"].items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes[:-2] + argtypes[-1:]
            self._fns[sym] = functools.partial(self._drop, fn)

    @staticmethod
    def _drop(fn, *args):
        return fn(*args[:-2], args[-1])

    def __getattr__(self, sym):
        if sym not in self._fns:
            raise AttributeError(sym)
        return self._fns[sym]


def ptxas_compare(source):
    """(kernels compiled under one name by both builds, those whose ptxas
    lines differ, the kernels only this build has) of ``source``."""
    mine = smoke.ptxas_report(source, lambda name: name)
    other = smoke.ptxas_report(f"{source}_other", lambda name: name)
    both = sorted(set(mine) & set(other))
    return (both, [n for n in both if mine[n] != other[n]],
            {n: mine[n] for n in mine if n not in other})


def main():
    if len(sys.argv) != 3 or sys.argv[1] not in MODES:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    from gsn_tpu_torch.ops.cuda import build
    from gsn_tpu_torch.train.loop import full_f32_matmuls

    mode, other = sys.argv[1:]
    source, tag, key = MODES[mode]
    dev = torch.device("cuda")
    card = smoke.card_line()
    smoke.log(f"[turns] card: {card}")
    full_f32_matmuls()
    # this tree's build of the source, fresh, for its ptxas lines
    if os.path.exists(os.path.join(build.BUILD_DIR, f"lib{source}.so")):
        os.remove(os.path.join(build.BUILD_DIR, f"lib{source}.so"))
    build.build_all()
    libs = {"other": build.build_other(source, other),
            "this": build.lib(source)}
    with open(os.path.join(other, f"{source}.cu")) as f:
        if mode == "k3" and "int form" not in f.read():
            libs["other"] = NoFormArgument(libs["other"])
    turns = ("other", "this", "this", "other")

    with tempfile.TemporaryDirectory() as root:
        if mode in ("dgn", "k4"):
            fns, paths = (dgn_case if mode == "dgn" else k4_case)(dev)
            fns = {name: (fn, True) for name, fn in fns.items()}
        else:
            fns, paths = {"k3": k3_case, "k1": k1_case,
                          "k2": k2_case}[mode](dev, root)
        cpm = smoke.spin_cycles_per_ms()
        result = {}
        for name, (fn, exact) in fns.items():
            if "[bf16]" in name and not hasattr(
                    libs["other"], "gsn_dgn_aggregate_fwd_bf16"):
                smoke.log(f"[turns] {name}: the other build has no bf16 "
                          "entry points; not turned")
                continue
            outs = {}
            for who in ("other", "this"):
                with build.use(source, libs[who]):
                    outs[who] = outputs(fn())
            same, err = same_or_close(outs["this"], outs["other"])
            if exact and not same:
                raise AssertionError(f"{name}: the builds' bits differ "
                                     f"(max abs err {err})")
            times = []
            for who in turns:
                with build.use(source, libs[who]):
                    times.append((who, smoke.time_ms(fn, cpm)[0]))
            result[name] = dict(same_bits=same, max_abs_err=err,
                                turns=times)
            smoke.log(f"[turns] {name}: same bits {same} (max abs err "
                      f"{err}); " + ", ".join(f"{who} {ms:.6f}"
                                              for who, ms in times))

        for path, (make_trainer, data) in paths.items():
            states, losses = {}, {}
            for who in ("other", "this"):
                trainer = make_trainer()
                state = trainer.init_state(seed=0)
                losses[who] = []
                with build.use(source, libs[who]):
                    for _ in range(STEPS):
                        state, loss = trainer.train_step(state, data)
                        losses[who].append(float(loss))
                states[who] = (trainer, state)
                smoke.log(f"[turns] {path} {who} losses {losses[who]}")
            result[f"{path} losses"] = losses
            result[f"{path} profiles"] = []
            for who in turns:
                with build.use(source, libs[who]):
                    busy, ours = busy_ms(*states[who], data, key)
                result[f"{path} profiles"].append((who, busy, ours))
                smoke.log(f"[turns] {path} {who}: device busy {busy:.3f} ms "
                          f"a step, {tag} {ours:.3f} ms")

    both, differ, new = ptxas_compare(source)
    result["ptxas"] = dict(both=len(both), differ=differ,
                           new=len(new))
    smoke.log(f"[turns] ptxas: {len(both)} kernels compiled under one name "
              f"by both builds, {len(differ)} with other lines: {differ}")
    if new:
        ours = {n: v for n, v in new.items() if key in n}
        most = max(v.get("regs", 0) for v in ours.values()) if ours else 0
        spill = sum(v.get("spill", 0) for v in ours.values())
        smoke.log(f"[turns] ptxas of this build's {len(ours)} {tag} "
                  f"kernels the other lacks: at most {most} registers, "
                  f"{spill} B spilled in all")
        for n, v in sorted(ours.items()):
            smoke.log(f"[turns]   {v} {n}")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
