"""Experiment CLI (counterpart of ``gsn_tpu/cli.py``, reference
``main.py``: flag surface at main.py:501-680; modes at :160-367).

Three modes over one split or 10-fold CV:
- ``isomorphism_test``: random-weight embedding disambiguation (SR);
- ``train``: full training with periodic eval + checkpointing;
- ``test``: evaluate a saved checkpoint.

Run: ``python -m gsn_tpu_torch.cli --dataset chemical --dataset_name ZINC
...`` with the reference package's flags.  It runs on the CUDA card
(``--device_idx`` picks which) and raises when there is none;
``--device cpu`` runs on the CPU.

``--parallel dp|ep`` with ``--parallel_devices N`` prepares the data
once, then spawns N ranks (``parallel.launch``: gloo ranks on the CPU,
NCCL ranks on cards 0..N-1, N at most the cards there are) that train
with ``parallel.ParallelTrainer``; only rank 0 writes the log and the
checkpoints, and the call returns rank 0's results.

The multi-process flags (``--coordinator_address host:port``,
``--num_procs_distributed N``, ``--process_id i``) make this process
rank i of N processes launched on their own
(``parallel/distributed.py``); ``--coordinator_address auto`` or no
address joins through ``env://``.  The process trains with a
``ParallelTrainer`` itself (``--parallel`` defaults to ``dp``); rank 0
counts the dataset and writes its cache before the others read it, and
only rank 0 writes the log, checkpoints and summaries or prints.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import parsing as parse
from .config import GSNConfig
from .data.encoding import encode
from .data.pipeline import prepare_dataset
from .data.splits import separate_data, separate_data_given_split
from .train.checkpoint import load_checkpoint
from .train.isomorphism import run_isomorphism_test
from .train.logging import RunLogger
from .train.loop import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gsn_tpu_torch")
    a = p.add_argument
    # seeds / splits (main.py:506-520)
    a("--seed", type=int, default=0)
    a("--split_seed", type=int, default=0)
    a("--np_seed", type=int, default=0)
    a("--fold_idx", type=parse.str2list2int,
      default=[0, 1, 2, 3, 4, 5, 6, 7, 8, 9])
    a("--onesplit", type=parse.str2bool, default=False)
    a("--multiprocessing", type=parse.str2bool, default=False)
    a("--num_processes", type=int, default=8)
    # loader knobs (reference main.py:519-520): accepted for
    # compatibility; batching here is host-side numpy, no worker pool
    a("--num_workers", type=int, default=0)
    a("--num_threads", type=int, default=1)
    # dataset (main.py:525-528)
    a("--dataset", type=str, default="bioinformatics")
    a("--dataset_name", type=str, default="MUTAG")
    a("--split", type=str, default="given")
    a("--root_folder", type=str, default="./datasets")
    a("--cache_folder", type=str, default=None)
    # features (main.py:532-544)
    a("--degree_as_tag", type=parse.str2bool, default=False)
    a("--retain_features", type=parse.str2bool, default=False)
    a("--features_scope", type=str, default="full")
    a("--vn", type=parse.str2bool, default=False)
    a("--vn_pooling", type=str, default="sum")
    a("--input_vn_encoder", type=str, default="one_hot_encoder")
    a("--d_out_vn_encoder", type=int, default=None)
    a("--d_out_vn", type=int, default=None)
    # substructures (main.py:552-559)
    a("--id_type", type=str, default="cycle_graph")
    a("--induced", type=parse.str2bool, default=False)
    a("--edge_automorphism", type=str, default="induced")
    a("--k", type=parse.str2list2int, default=[3])
    a("--id_scope", type=str, default="local")
    a("--custom_edge_list", type=parse.str2ListOfListsOfLists2int,
      default=None)
    a("--directed", type=parse.str2bool, default=False)
    a("--directed_orbits", type=parse.str2bool, default=False)
    # encodings (main.py:563-584)
    a("--id_encoding", type=str, default="one_hot_unique")
    a("--degree_encoding", type=str, default="one_hot_unique")
    # binning-encoder knobs (reference main.py:568-573): accepted for
    # command-line compatibility but inert — the binning encoders are
    # commented out in the reference too (utils_encoding.py:73-140)
    a("--id_bins", type=parse.str2list2int, default=None)
    a("--degree_bins", type=parse.str2list2int, default=None)
    a("--id_strategy", type=str, default="uniform")
    a("--degree_strategy", type=str, default="uniform")
    a("--id_range", type=parse.str2list2int, default=None)
    a("--degree_range", type=parse.str2list2int, default=None)
    a("--id_embedding", type=str, default="one_hot_encoder")
    a("--d_out_id_embedding", type=int, default=None)
    a("--degree_embedding", type=str, default="one_hot_encoder")
    a("--d_out_degree_embedding", type=int, default=None)
    a("--input_node_encoder", type=str, default="None")
    a("--d_out_node_encoder", type=int, default=None)
    a("--edge_encoder", type=str, default="None")
    a("--d_out_edge_encoder", type=int, default=None)
    a("--multi_embedding_aggr", type=str, default="sum")
    a("--extend_dims", type=parse.str2bool, default=True)
    # model (main.py:602-635)
    a("--model_name", type=str, default="GSN_sparse")
    a("--random_features", type=parse.str2bool, default=False)
    a("--num_mlp_layers", type=int, default=2)
    a("--d_h", type=int, default=None)
    a("--activation_mlp", type=str, default="relu")
    a("--bn_mlp", type=parse.str2bool, default=True)
    a("--num_layers", type=int, default=2)
    a("--d_msg", type=int, default=None)
    a("--d_out", type=int, default=16)
    a("--bn", type=parse.str2bool, default=True)
    a("--dropout_features", type=float, default=0)
    a("--activation", type=str, default="relu")
    a("--train_eps", type=parse.str2bool, default=False)
    a("--aggr", type=str, default="add")
    a("--flow", type=str, default="source_to_target")
    a("--final_projection", type=parse.str2list2bool, default=[True])
    a("--jk_mlp", type=parse.str2bool, default=False)
    a("--residual", type=parse.str2bool, default=False)
    a("--readout", type=str, default="sum")
    a("--msg_kind", type=str, default="general")
    a("--inject_ids", type=parse.str2bool, default=False)
    a("--inject_degrees", type=parse.str2bool, default=False)
    a("--inject_edge_features", type=parse.str2bool, default=True)
    # optimization (main.py:638-657)
    a("--shuffle", type=parse.str2bool, default=True)
    a("--batch_size", type=int, default=16)
    a("--num_epochs", type=int, default=300)
    a("--num_iters", type=int, default=None)
    a("--num_iters_test", type=int, default=None)
    a("--eval_frequency", type=int, default=1)
    a("--lr", type=float, default=0.01)
    a("--regularization", type=float, default=0)
    a("--scheduler", type=str, default="StepLR")
    a("--scheduler_mode", type=str, default="min")
    a("--min_lr", type=float, default=0.0)
    a("--decay_steps", type=int, default=50)
    a("--decay_rate", type=float, default=0.5)
    a("--patience", type=int, default=20)
    a("--regression", type=parse.str2bool, default=False)
    a("--loss_fn", type=str, default="CrossEntropyLoss")
    a("--prediction_fn", type=str, default="multi_class_accuracy")
    # misc (main.py:660-676)
    a("--results_folder", type=str, default="temp")
    a("--checkpoint_file", type=str, default="checkpoint")
    a("--mode", type=str, default="train")
    a("--resume", type=parse.str2bool, default=False)
    a("--device_idx", type=int, default=0,
      help="reference main.py:668; the CUDA card cuda:<idx> (raises when "
           "there is no such card)")
    # experiment logging (reference main.py:669-672); the sink degrades
    # to JSONL when the wandb package is unavailable (train/logging.py)
    a("--wandb", type=parse.str2bool, default=True)
    a("--wandb_realtime", type=parse.str2bool, default=False)
    a("--wandb_project", type=str, default="gsn_project")
    a("--wandb_entity", type=str, default="anonymous")
    a("--isomorphism_eps", type=float, default=1e-2)
    a("--return_scores", action="store_true")
    a("--use_mxu", type=parse.str2bool, default=False,
      help="the reference package's kernel layout switch; accepted, with "
           "no effect here (on the card the kernels always run)")
    a("--compute_dtype", type=str, default=None,
      choices=[None, "None", "bfloat16"],
      help="'bfloat16' = mixed-precision compute (bf16 node rows and "
           "products, f32 master params/BN/Adam), through the kernels' "
           "bf16 modes")
    a("--dropout_rng", type=str, default="threefry",
      choices=["threefry", "rbg"],
      help="the reference package's dropout bit generator; accepted, "
           "the port draws its masks from a torch.Generator either way")
    a("--caps_mode", type=str, default="worst",
      choices=["worst", "tight"],
      help="batch padding caps: 'worst' = one shape for the whole run; "
           "'tight' re-buckets per epoch (less padding on skewed data)")
    a("--device", type=str, default="default",
      help="default (the CUDA card; raises when there is none) | cpu")
    # multi-device execution (gsn_tpu_torch.parallel)
    a("--parallel", type=str, default="none",
      choices=["none", "dp", "ep"],
      help="'dp' shards each batch's graphs across ranks, 'ep' "
           "edge-partitions each batch")
    a("--parallel_devices", type=int, default=None,
      help="ranks of --parallel (default: every card, or 1 on the CPU)")
    a("--coordinator_address", type=str, default=None,
      help="multi-process: rank 0's host:port, or 'auto' for env:// "
           "(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)")
    a("--num_procs_distributed", type=int, default=None,
      help="multi-process: the number of processes")
    a("--process_id", type=int, default=None,
      help="multi-process: this process's rank (its card: LOCAL_RANK, "
           "else the rank modulo the visible cards)")
    return p


def _model_config(args: Dict, num_classes, in_features, in_edge_features,
                  d_in_node_encoder, d_in_edge_encoder, d_id,
                  d_degree) -> GSNConfig:
    return GSNConfig(
        model_name=args["model_name"],
        num_layers=args["num_layers"],
        d_out=args["d_out"],
        d_msg=args["d_msg"],
        d_h=args["d_h"],
        num_mlp_layers=args["num_mlp_layers"],
        out_features=num_classes,
        msg_kind=args["msg_kind"],
        id_scope=args["id_scope"],
        aggr=args["aggr"],
        flow=args["flow"],
        input_node_encoder=args["input_node_encoder"],
        d_out_node_encoder=args["d_out_node_encoder"],
        edge_encoder=args["edge_encoder"],
        d_out_edge_encoder=args["d_out_edge_encoder"],
        id_embedding=args["id_embedding"],
        d_out_id_embedding=args["d_out_id_embedding"],
        degree_embedding=args["degree_embedding"],
        d_out_degree_embedding=args["d_out_degree_embedding"],
        input_vn_encoder=args["input_vn_encoder"],
        d_out_vn_encoder=args["d_out_vn_encoder"],
        d_out_vn=args["d_out_vn"],
        multi_embedding_aggr=args["multi_embedding_aggr"],
        extend_dims=args["extend_dims"],
        features_scope=args["features_scope"],
        inject_ids=args["inject_ids"],
        inject_degrees=args["inject_degrees"],
        inject_edge_features=args["inject_edge_features"],
        degree_as_tag=args["degree_as_tag"],
        retain_features=args["retain_features"],
        random_features=args["random_features"],
        bn=args["bn"],
        bn_mlp=args["bn_mlp"],
        compute_dtype=(None if args.get("compute_dtype") in (None, "None")
                       else args["compute_dtype"]),
        dropout_rng=args.get("dropout_rng", "threefry"),
        activation_mlp=args["activation_mlp"],
        activation=args["activation"],
        final_projection=args["final_projection"],
        jk_mlp=args["jk_mlp"],
        dropout_features=args["dropout_features"],
        readout=args["readout"],
        train_eps=args["train_eps"],
        vn=args["vn"],
        vn_pooling=args["vn_pooling"],
        residual=args["residual"],
        in_features=in_features,
        in_edge_features=in_edge_features,
        d_in_node_encoder=d_in_node_encoder,
        d_in_edge_encoder=d_in_edge_encoder,
        d_in_id=d_id,
        d_degree=d_degree,
    )


def select_device(args: Dict) -> torch.device:
    """``--device cpu``: the CPU.  Otherwise the CUDA card
    ``cuda:<device_idx>``; raises when there is no such card."""
    if args.get("device") == "cpu":
        return torch.device("cpu")
    if args.get("device") not in (None, "default"):
        raise ValueError(f"unknown --device {args['device']!r} (default "
                         f"or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    idx = args.get("device_idx") or 0
    if not 0 <= idx < torch.cuda.device_count():
        raise ValueError(f"--device_idx {idx}: there are "
                         f"{torch.cuda.device_count()} CUDA devices")
    return torch.device(f"cuda:{idx}")


def multi_process(args: Dict) -> bool:
    """This process is one of several launched on their own: a
    multi-process flag is set."""
    return any(args.get(k) is not None for k in (
        "coordinator_address", "num_procs_distributed", "process_id"))


def parallel_ranks(args: Dict, device: torch.device) -> int:
    """``--parallel_devices``, by default every card (1 on the CPU)."""
    n = args.get("parallel_devices")
    if n is None:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 1:
        raise ValueError(f"--parallel_devices {n}")
    return n


def dataset_path(args: Dict) -> str:
    return os.path.join(args["root_folder"], args["dataset"],
                        args["dataset_name"])


def prepare(args: Dict) -> Tuple[List[Dict], GSNConfig]:
    """Load, count, cache and encode the dataset; returns (graphs, the
    model config) (reference main.py:66-158)."""
    path = dataset_path(args)
    graphs, num_classes, _orbit_sizes = prepare_dataset(
        path, args["dataset"], args["dataset_name"],
        id_scope=args["id_scope"], id_type=args["id_type"], k=args["k"],
        regression=args["regression"], induced=args["induced"],
        directed_orbits=args["directed_orbits"],
        custom_edge_list=args["custom_edge_list"],
        root_folder=args["root_folder"],
        num_processes=(args["num_processes"]
                       if args["multiprocessing"] else 1),
        cache_root=args.get("cache_folder"))

    # OGB simple feature scope (reference main.py:89-103)
    if args["dataset"] == "ogb" and args["features_scope"] == "simple":
        for g in graphs:
            g["x"] = g["x"][:, :2]
            g["edge_features"] = g["edge_features"][:, :2]

    in_features = graphs[0]["x"].shape[1] if graphs[0]["x"].ndim > 1 else 1
    has_ef = "edge_features" in graphs[0] and graphs[0]["edge_features"] \
        is not None
    in_edge_features = (graphs[0]["edge_features"].shape[1]
                        if has_ef and graphs[0]["edge_features"].ndim > 1
                        else (1 if has_ef else None))
    if args["dataset"] == "chemical" and args["dataset_name"] == "ZINC":
        d_in_node_encoder, d_in_edge_encoder = [28], [4]
    else:
        d_in_node_encoder = [in_features]
        d_in_edge_encoder = [in_edge_features]

    degree_encoding = (args["degree_encoding"]
                       if args["degree_as_tag"] else None)
    id_encoding = (args["id_encoding"]
                   if args["id_encoding"] != "None" else None)
    graphs, _enc_ids, d_id, _enc_deg, d_degree = encode(
        graphs, id_encoding, degree_encoding)

    cfg = _model_config(args, num_classes, in_features, in_edge_features,
                        d_in_node_encoder, d_in_edge_encoder, d_id,
                        d_degree)
    return graphs, cfg


def prepare_shared(args: Dict) -> Tuple[List[Dict], GSNConfig]:
    """``prepare`` in every process of the group, rank 0 first: it counts
    the dataset and writes its cache while the others wait at a barrier,
    then they read the cache (else each would write the same file at
    once).  A cold count longer than the group's timeout
    (``parallel.mesh.DEFAULT_TIMEOUT_S``) times the barrier out: count
    such a dataset in one process first."""
    import torch.distributed as dist
    first = dist.get_rank() == 0
    if first:
        out = prepare(args)
    dist.barrier()
    if not first:
        out = prepare(args)
    return out


def trainer_config(args: Dict) -> TrainerConfig:
    return TrainerConfig(
        lr=args["lr"], regularization=args["regularization"],
        scheduler=args["scheduler"], decay_steps=args["decay_steps"],
        decay_rate=args["decay_rate"], patience=args["patience"],
        min_lr=args["min_lr"], batch_size=args["batch_size"],
        num_epochs=args["num_epochs"], num_iters=args["num_iters"],
        num_iters_test=args["num_iters_test"],
        eval_frequency=args["eval_frequency"], loss_fn=args["loss_fn"],
        prediction_fn=args["prediction_fn"],
        evaluator=("rocauc" if (args["dataset"] == "ogb" and
                                args["dataset_name"] != "ogbg-ppa")
                   else None),
        seed=args["seed"], shuffle=args["shuffle"],
        caps_mode=args.get("caps_mode", "worst"),
        use_mxu_segment_sum=args.get("use_mxu", False))


def fold_splits(args: Dict, graphs: List[Dict], fold: int
                ) -> Tuple[List[Dict], List[Dict], Optional[List[Dict]]]:
    """(train, test, val or None) of one fold (fold -1: the one split)."""
    if args["split"] == "given":
        return separate_data_given_split(graphs, dataset_path(args), fold)
    train, test = separate_data(graphs, args["split_seed"], fold)
    return train, test, None


def run_dir(args: Dict, fold: int) -> str:
    """Where a fold's log.jsonl, params.json and checkpoints go."""
    return os.path.join(args.get("cache_folder") or dataset_path(args),
                        "results", args["results_folder"], str(fold),
                        args["model_name"])


def checkpoint_path(args: Dict, fold: int) -> str:
    return os.path.join(run_dir(args, fold), "checkpoints",
                        args["checkpoint_file"] + ".pt")


def main(args: Dict):
    """Programmatic entry (mirrors reference main.main(args))."""
    if not multi_process(args):
        return run_main(args, select_device(args))
    if args["mode"] == "isomorphism_test":
        raise ValueError("--mode isomorphism_test runs on one device; "
                         "drop the multi-process flags")
    # the card is the process's local one (initialize), not --device_idx
    cpu = select_device(args).type == "cpu"
    from .parallel import distributed
    addr = args.get("coordinator_address")
    threads = torch.get_num_threads()
    try:
        device = distributed.initialize(
            None if addr == "auto" else addr,
            args.get("num_procs_distributed"), args.get("process_id"),
            platform="cpu" if cpu else None)
        # one thread a rank, as parallel.launch's ranks run
        torch.set_num_threads(1)
        return run_main(args, device, multi=True)
    finally:
        torch.set_num_threads(threads)
        distributed.shutdown()


def run_main(args: Dict, device: torch.device, multi: bool = False):
    """``main`` on ``device``; ``multi``: in a process of a group that
    ``parallel.distributed.initialize`` formed."""
    np.random.seed(args["np_seed"])
    graphs, cfg = prepare_shared(args) if multi else prepare(args)
    par = args.get("parallel", "none") or "none"

    if args["mode"] == "isomorphism_test":
        if par != "none":
            raise ValueError("--mode isomorphism_test runs on one device; "
                             "drop --parallel")
        pairs, fails, frac = run_isomorphism_test(
            graphs, cfg, seed=args["seed"], batch_size=args["batch_size"],
            eps=args["isomorphism_eps"], device=device)
        print(f"Total pairs: {pairs}")
        print(f"Number of non-isomorphic pairs that are not "
              f"distinguised: {fails}")
        print(f"Failure Percentage: {100 * frac:.2f}%")
        return {"failure_percentage": frac, "pairs": pairs, "fails": fails}

    if multi:
        return _distributed_rank(args, graphs, cfg, par)
    if par != "none":
        from .parallel import launch
        return launch(_parallel_rank, parallel_ranks(args, device),
                      device.type, args=(args, graphs, cfg, par))[0]
    tcfg = trainer_config(args)
    return run_folds(args, graphs,
                     lambda train: Trainer(cfg, tcfg, train, device=device))


def _distributed_rank(args: Dict, graphs: List[Dict], cfg: GSNConfig,
                      mode: str):
    """This process's rank of a multi-process run: the folds with a
    ``ParallelTrainer`` over the group (``--parallel``, by default dp);
    only rank 0 writes and prints."""
    from .parallel import ParallelTrainer, distributed
    write = distributed.is_coordinator()
    if mode == "none":
        # N processes without a parallel mode would train N copies
        if write:
            print("[gsn_tpu_torch] multi-process run: defaulting "
                  "--parallel to 'dp'")
        mode = "dp"
    mesh = distributed.global_mesh(mode)
    n = args.get("parallel_devices")
    if n is not None and n != mesh.size:
        raise ValueError(f"--parallel_devices {n}: the multi-process run "
                         f"has {mesh.size} processes")
    np.random.seed(args["np_seed"])
    tcfg = trainer_config(args)
    return run_folds(
        args, graphs,
        lambda train: ParallelTrainer(cfg, tcfg, train, mesh=mesh,
                                      mode=mode, distributed=True),
        write=write)


def _parallel_rank(rank: int, args: Dict, graphs: List[Dict],
                   cfg: GSNConfig, mode: str):
    """One rank of ``--parallel``: the folds with a ``ParallelTrainer``;
    only rank 0 writes."""
    from .parallel import ParallelTrainer, make_mesh
    mesh = make_mesh(axis_names=(mode,))
    np.random.seed(args["np_seed"])
    tcfg = trainer_config(args)
    return run_folds(
        args, graphs,
        lambda train: ParallelTrainer(cfg, tcfg, train, mesh=mesh,
                                      mode=mode),
        write=rank == 0)


def run_folds(args: Dict, graphs: List[Dict], make_trainer,
              write: bool = True):
    """Train (or test) each fold with ``make_trainer(train split)``;
    ``write``: this process writes the logs, checkpoints and summaries
    (every process reads the checkpoints)."""
    fold_idxs = [-1] if args["onesplit"] else args["fold_idx"]
    perf_opt = np.argmin if args["regression"] else np.argmax

    results = []
    for fold in fold_idxs:
        train, test, val = fold_splits(args, graphs, fold)
        trainer = make_trainer(train)
        state = trainer.init_state(seed=args["seed"])
        ckpt = checkpoint_path(args, fold)

        if args["mode"] == "test":
            state, _ = load_checkpoint(ckpt, state, trainer.scheduler,
                                       trainer.rng)
            loss, acc = trainer.evaluate(state, test)
            if write:
                print(f"Fold {fold}: test loss {loss:.4f}, "
                      f"metric {acc:.4f}")
            results.append({"test_loss": loss, "test_acc": acc})
            continue

        if args["resume"] and os.path.exists(ckpt):
            state, _ = load_checkpoint(ckpt, state, trainer.scheduler,
                                       trainer.rng)

        # per-fold run logger (reference wandb realtime logging at
        # train_test_funcs.py:150-159; JSONL fallback without wandb)
        logger = None
        if write:
            logger = RunLogger(
                run_dir=run_dir(args, fold),
                use_wandb=args.get("wandb", False),
                realtime=args.get("wandb_realtime", False),
                project=args.get("wandb_project", "gsn_project"),
                entity=args.get("wandb_entity", None),
                config=args)
            logger.watch(state.model)   # reference wandb.watch, main.py:296
        state, hist = trainer.fit(state, train, test, graphs_val=val,
                                  checkpoint_file=ckpt if write else None,
                                  logger=logger,
                                  log_fn=print if write else None)
        if logger is not None:
            if hist["test_accs"]:
                fold_perf = perf_opt(hist["test_accs"])
                logger.set_summary(
                    last_test_acc=hist["test_accs"][-1],
                    best_test_acc=hist["test_accs"][int(fold_perf)],
                    best_epoch=int(fold_perf) * args["eval_frequency"])
            logger.close()
        results.append(hist)

    if args["mode"] == "test":
        return results

    # fold aggregation (reference main.py:376-498)
    agg = {}
    if results and results[0]["test_accs"]:
        accs = np.array([r["test_accs"] for r in results])  # [folds, evals]
        mean_curve = accs.mean(0)
        best_idx = int(perf_opt(mean_curve))
        agg = {
            "last_test_mean": float(accs[:, -1].mean()),
            "last_test_std": float(accs[:, -1].std()),
            "best_test_mean": float(mean_curve[best_idx]),
            "best_test_std": float(accs[:, best_idx].std()),
            "best_epoch": best_idx * args["eval_frequency"],
        }
        if write:
            print(json.dumps(agg))
    if args.get("return_scores"):
        return agg
    return results


def cli():
    args = vars(build_parser().parse_args())
    main(args)


if __name__ == "__main__":
    cli()
