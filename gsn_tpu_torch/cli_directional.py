"""Directional-GSN experiment driver (counterpart of
``gsn_tpu/cli_directional.py``, reference ``directional_gsn/main_HIV.py``):
a JSON config plus flag overrides, the molhiv pipeline (counts, the
split files, the vector fields), then train / evaluate epochs with
ReduceLROnPlateau stepped on -val ROC, the ``min_lr`` and ``max_time``
stops, and the best-val ``(epoch, val ROC, test ROC)`` as the result.

Run: ``python -m gsn_tpu_torch.cli_directional --dataset ogbg-molhiv
--directions subgraphs --id_type cycle_graph --k 6 --id_scope local ...``
with the reference's flags.  It runs on the CUDA card and raises when
there is none; ``--device cpu`` runs on the CPU.  ``--parallel dp``
with ``--parallel_devices N`` spawns N ranks (``parallel.launch``) that
train ``DGNNet`` data-parallel with ``parallel.ParallelTrainer``, its BN
statistics over the whole batch; rank 0 prints and its result is
returned.  ``--use_mxu`` and ``--dropout_rng`` are the reference's
kernel-layout and bit-generator switches: accepted, with no effect here
(the kernels always run on the card, and dropout masks come from the
trainer's ``torch.Generator``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import parsing as parse
from .data.directional import assemble_directions
from .data.encoding import encode
from .data.pipeline import prepare_dataset
from .nn.dgn import DGNConfig, DGNNet, compute_avg_d
from .train.loop import Trainer, TrainerConfig


def build_parser():
    p = argparse.ArgumentParser("gsn_tpu.directional")
    a = p.add_argument
    a("--config", type=str, default=None, help="JSON config file")
    a("--expid", type=str, default="", help="experiment id (tag only)")
    a("--print_epoch_interval", type=int, default=5)
    a("--dataset", type=str, default="ogbg-molhiv")
    a("--data_root", type=str, default="./datasets/ogb")
    a("--cache_folder", type=str, default=None)
    a("--seed", type=int, default=41)
    a("--epochs", type=int, default=200)
    a("--batch_size", type=int, default=128)
    a("--init_lr", type=float, default=0.01)
    a("--lr_reduce_factor", type=float, default=0.5)
    a("--lr_schedule_patience", type=int, default=20)
    a("--min_lr", type=float, default=1e-4)
    a("--weight_decay", type=float, default=3e-6)
    a("--max_time", type=float, default=48.0, help="hours")
    a("--L", type=int, default=4)
    a("--hidden_dim", type=int, default=70)
    a("--out_dim", type=int, default=70)
    a("--type_net", type=str, default="simple")
    a("--residual", type=parse.str2bool, default=True)
    a("--edge_feat", type=parse.str2bool, default=False)
    a("--readout", type=str, default="mean")
    a("--in_feat_dropout", type=float, default=0.0)
    a("--dropout", type=float, default=0.3)
    a("--graph_norm", type=parse.str2bool, default=False)
    a("--batch_norm", type=parse.str2bool, default=True)
    a("--aggregators", type=str, default="mean max min dir1-dx dir1-av")
    a("--scalers", type=str, default="identity")
    a("--posttrans_layers", type=int, default=1)
    a("--pos_enc_dim", type=int, default=0)
    a("--norm", type=str, default="none")
    # substructure directions (reference main_HIV subgraph params)
    a("--directions", type=str, default="subgraphs",
      help="space-separated subset of: eig subgraphs edge_feat")
    a("--id_type", type=str, default="cycle_graph")
    a("--induced", type=parse.str2bool, default=False)
    a("--k", type=parse.str2list2int, default=[6])
    a("--id_scope", type=str, default="local")
    a("--id_encoding", type=str, default="one_hot_unique")
    a("--multiprocessing", type=parse.str2bool, default=True)
    a("--num_processes", type=int, default=8)
    a("--device", type=str, default="default",
      help="default (the CUDA card; raises when there is none) | cpu")
    a("--use_mxu", type=parse.str2bool, default=True,
      help="the reference package's kernel layout switch; accepted, with "
           "no effect here (on the card the kernels always run)")
    a("--compute_dtype", type=str, default=None,
      choices=[None, "None", "bfloat16"],
      help="'bfloat16' = bf16 matmuls/activations (f32 BN stats, loss, "
           "readout head)")
    a("--dropout_rng", type=str, default="threefry",
      choices=["threefry", "rbg"],
      help="the reference package's dropout bit generator; accepted, the "
           "port draws its masks from a torch.Generator either way")
    # data-parallel ranks (parallel.launch + ParallelTrainer): BN
    # statistics and the loss over the whole batch
    a("--parallel", type=str, default="none", choices=["none", "dp"])
    a("--parallel_devices", type=int, default=None,
      help="ranks (default: every card, or 1 on the CPU)")
    return p


def load_config(args: Dict, explicit=None) -> Dict:
    """JSON config file + CLI overrides (reference main_HIV.py:249-357).

    The config file is the *primary* input: its ``params``/``net_params``
    values replace the parser defaults.  CLI flags win only when the user
    explicitly gave them — ``explicit`` is that set of arg names (the
    reference gets the same effect by parsing every flag with a None
    default and copying non-None values over the config).  Programmatic
    callers that pass a plain dict (e.g. the 10-seed scripts) are treated
    as all-explicit unless they supply ``explicit`` themselves.
    """
    if args.get("config") and os.path.exists(args["config"]):
        with open(args["config"]) as f:
            cfg = json.load(f)
        for k, v in {**cfg.get("params", {}),
                     **cfg.get("net_params", {})}.items():
            if k not in args:
                continue
            if (explicit is None and args[k] is not None) or \
                    (explicit is not None and k in explicit):
                continue  # CLI override wins
            args[k] = v
    return args


def _explicit_flags(parser: argparse.ArgumentParser, argv=None):
    """Names of flags the user actually typed, via a SUPPRESS-default
    shadow parser (so parser defaults never appear in the namespace)."""
    shadow = argparse.ArgumentParser(add_help=False)
    for act in parser._actions:
        if act.dest == "help":
            continue
        shadow.add_argument(*act.option_strings, dest=act.dest,
                            type=act.type, nargs=act.nargs,
                            default=argparse.SUPPRESS)
    ns, _ = shadow.parse_known_args(argv)
    return set(vars(ns).keys())


def select_device(args: Dict) -> torch.device:
    """``--device cpu``: the CPU.  Otherwise the CUDA card; raises when
    there is none."""
    if args.get("device") == "cpu":
        return torch.device("cpu")
    if args.get("device") not in (None, "default"):
        raise ValueError(f"unknown --device {args['device']!r} (default "
                         f"or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return torch.device("cuda")


def prepare(args: Dict):
    """The molhiv pipeline (reference main_HIV.py + HIV.py): count and
    encode, split by ``10fold_idx/{train,val,test}_idx-1.txt``, then
    assemble each split's vector fields (filtering graphs of at most 5
    nodes after the split, as HIVDGL does).  Returns (train, val, test,
    number of tasks)."""
    path = os.path.join(args["data_root"], args["dataset"])
    graphs, num_tasks, _sizes = prepare_dataset(
        path, "ogb", args["dataset"], id_scope=args["id_scope"],
        id_type=args["id_type"], k=args["k"], induced=args["induced"],
        num_processes=(args["num_processes"]
                       if args["multiprocessing"] else 1),
        cache_root=args.get("cache_folder"))
    graphs, _eid, _d_id, _ed, _dd = encode(
        graphs, args["id_encoding"] if args["id_encoding"] != "None"
        else None)
    directions = args["directions"].split()

    def split(name):
        idx = np.loadtxt(os.path.join(path, "10fold_idx",
                                      f"{name}_idx-1.txt"), dtype=int)
        return assemble_directions(
            [graphs[i] for i in np.atleast_1d(idx)], directions=directions,
            id_scope=args["id_scope"], pos_enc_dim=args["pos_enc_dim"],
            norm=args["norm"])

    train, test, val = split("train"), split("test"), split("val")
    return train, val, test, num_tasks


def model_config(args: Dict, avg_d, num_tasks) -> DGNConfig:
    par = args.get("parallel", "none") or "none"
    return DGNConfig(
        bn_axis_name=("dp" if par == "dp" else None),
        hidden_dim=args["hidden_dim"], out_dim=args["out_dim"],
        num_layers=args["L"], aggregators=tuple(args["aggregators"].split()),
        scalers=tuple(args["scalers"].split()), avg_d=avg_d,
        readout=args["readout"], residual=args["residual"],
        edge_feat=args["edge_feat"],
        in_feat_dropout=args["in_feat_dropout"], dropout=args["dropout"],
        graph_norm=args["graph_norm"], batch_norm=args["batch_norm"],
        pos_enc_dim=args["pos_enc_dim"],
        posttrans_layers=args["posttrans_layers"], out_features=num_tasks,
        compute_dtype=(None if args.get("compute_dtype") in (None, "None")
                       else args["compute_dtype"]))


def trainer_config(args: Dict) -> TrainerConfig:
    return TrainerConfig(
        lr=args["init_lr"], regularization=args["weight_decay"],
        scheduler="ReduceLROnPlateau",
        decay_rate=args["lr_reduce_factor"],
        patience=args["lr_schedule_patience"], min_lr=args["min_lr"],
        batch_size=args["batch_size"], num_epochs=args["epochs"],
        loss_fn="BCEWithLogitsLoss", prediction_fn="None",
        evaluator="rocauc", seed=args["seed"], caps_mode="worst",
        use_mxu_segment_sum=bool(args.get("use_mxu", True)))


def main(args: Dict, explicit=None, history: Optional[List] = None):
    """Programmatic entry (mirrors reference main_HIV.main).  Returns the
    best-val ``(epoch, val ROC, test ROC)``, or None when no epoch ran.
    ``history``: a list that gets one record a finished epoch (its train
    loss, val and test loss and ROC, lr and the epoch's host stats)."""
    args = load_config(args, explicit)
    device = select_device(args)
    np.random.seed(args["seed"])
    train, val, test, num_tasks = prepare(args)
    cfg = model_config(args, compute_avg_d(train), num_tasks)
    tcfg = trainer_config(args)
    if (args.get("parallel", "none") or "none") == "dp":
        from .parallel import launch
        n = args.get("parallel_devices")
        if n is None:
            n = torch.cuda.device_count() if device.type == "cuda" else 1
        best, hist = launch(_parallel_rank, n, device.type,
                            args=(args, cfg, tcfg, train, val, test))[0]
    else:
        trainer = Trainer(cfg, tcfg, train, device=device,
                          model=DGNNet(cfg))
        best, hist = run_epochs(args, trainer, train, val, test)
    if history is not None:
        history.extend(hist)
    return best


def _parallel_rank(rank: int, args: Dict, cfg: DGNConfig,
                   tcfg: TrainerConfig, train, val, test):
    """One rank of ``--parallel dp``; only rank 0 prints."""
    from .parallel import ParallelTrainer, make_mesh
    np.random.seed(args["seed"])
    mesh = make_mesh(axis_names=("dp",))
    trainer = ParallelTrainer(cfg, tcfg, train, mesh=mesh, mode="dp",
                              model=DGNNet(cfg))
    return run_epochs(args, trainer, train, val, test, verbose=rank == 0)


def run_epochs(args: Dict, trainer, train, val, test, verbose=True):
    """Train epochs with Plateau on -val ROC (reference main_HIV.py:148),
    the ``min_lr`` and ``max_time`` stops; returns (best-val (epoch, val
    ROC, test ROC) or None, the epochs' records)."""
    say = print if verbose else (lambda *a, **k: None)
    state = trainer.init_state(seed=args["seed"])
    t_start = time.time()
    best_val, best, hist = -1.0, None, []
    interval = max(1, int(args.get("print_epoch_interval") or 1))
    for epoch in range(args["epochs"]):
        state, train_loss = trainer.train_epoch(state, train)
        val_loss, val_roc = trainer.evaluate(state, val)
        test_loss, test_roc = trainer.evaluate(state, test)
        trainer.scheduler.step(-val_roc)
        hist.append(dict(epoch=epoch, train_loss=train_loss,
                         val_loss=val_loss, val_roc=val_roc,
                         test_loss=test_loss, test_roc=test_roc,
                         lr=trainer.scheduler.lr, **trainer.epoch_stats))
        if val_roc > best_val:
            best_val, best = val_roc, (epoch, val_roc, test_roc)
        if epoch % interval == 0 or epoch == args["epochs"] - 1:
            say(f"epoch {epoch:03d} loss {train_loss:.4f} "
                f"val ROC {val_roc:.4f} test ROC {test_roc:.4f} "
                f"lr {trainer.scheduler.lr:.6f}")
        if trainer.scheduler.lr < args["min_lr"]:
            say("lr below min_lr, stopping")
            break
        if time.time() - t_start > args["max_time"] * 3600:
            say("max_time reached, stopping")
            break
    if best is None:
        say("no epochs ran (epochs=0)")
        return None, hist
    say(f"best-val epoch {best[0]}: val {best[1]:.4f} test {best[2]:.4f}")
    return best, hist


def cli():
    parser = build_parser()
    main(vars(parser.parse_args()), explicit=_explicit_flags(parser))


if __name__ == "__main__":
    cli()
