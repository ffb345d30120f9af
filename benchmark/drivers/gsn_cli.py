"""The driver of configurations run by ``python -m gsn_tpu_torch.cli``:
the one file of the harness that reaches into that CLI.

A driver is the harness's whole view of how a configuration's program
is prepared, built and run an epoch at a time; ``core/program.py``
takes everything else from it.  Each configuration file names its
driver (``"driver": "<name>"``, this file is ``drivers/<name>.py``),
and every driver provides:

- ``prepare(flags, splits, seed) -> (args, splits, model_cfg,
  id_dims)``: the program's data path on the harness's molecules
  (``splits``: {split name: graphs as the program's loader returns
  them}), run as the CLI runs it with ``flags`` and ``--seed seed``;
  ``args`` are the parsed flags, ``splits`` the prepared splits (the
  same names), ``id_dims`` the vocabulary size of each id column that
  the program encoded;
- ``trainer(args, model_cfg, train, device) -> Trainer``: the
  program's trainer of the train split, as the CLI builds it;
- ``epoch(trainer, state, splits, logger) -> state``: one epoch as the
  CLI runs it.  It logs one record (``logger.log(record, step=...)``)
  that holds ``epoch_s``, ``eval_s``, ``steps``, each evaluated
  split's ``<split>_loss``, ``host_batch_s``, ``step_median_s``,
  ``spans`` (over the whole epoch) and the counters of the trainer's
  ``epoch_stats`` with the epoch's ``eval.steps`` and
  ``eval.captures``;
- ``EVAL_SPLITS``: the splits one epoch evaluates;
- ``hyper(flags) -> {lr, weight_decay, batch_size}``: the optimizer's
  rate and L2 weight decay (torch's form, added to the gradient) and
  the train batch, for the reference.

Here an epoch is ``Trainer.fit`` for one epoch: a train epoch, the
evaluation of the train, test and val splits, the scheduler's step
(Plateau on the val loss).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

EVAL_SPLITS = ("train", "test", "val")


def argv_of(flags: Dict[str, str], seed: int) -> List[str]:
    out = []
    for k, v in flags.items():
        out += [k, str(v)]
    return out + ["--seed", str(seed)]


def prepare(flags: Dict[str, str], splits: Dict[str, List[Dict]],
            seed: int):
    """The CLI's ``prepare`` on graphs a loader returned (``cli.prepare``
    minus the file read and the cache), then its splits."""
    from gsn_tpu_torch.cli import _model_config, build_parser
    from gsn_tpu_torch.data.encoding import encode
    from gsn_tpu_torch.data.pipeline import generate_dataset
    from gsn_tpu_torch.graphs.patterns import resolve_pattern_vocabulary

    args = vars(build_parser().parse_args(argv_of(flags, seed)))
    names = list(splits)
    graphs = [g for n in names for g in splits[n]]
    vocab = resolve_pattern_vocabulary(
        args["id_type"], args["k"], root_folder=args["root_folder"],
        custom_edge_list=args["custom_edge_list"])
    graphs, _sizes = generate_dataset(
        graphs, vocab, id_scope=args["id_scope"], induced=args["induced"],
        directed_orbits=args["directed_orbits"],
        num_processes=(args["num_processes"] if args["multiprocessing"]
                       else 1))
    num_classes = int(np.asarray(graphs[0]["y"]).size)
    in_features = graphs[0]["x"].shape[1] if graphs[0]["x"].ndim > 1 else 1
    ef = graphs[0]["edge_features"]
    in_edge_features = ef.shape[1] if ef.ndim > 1 else 1
    if args["dataset"] == "chemical" and args["dataset_name"] == "ZINC":
        d_in_node, d_in_edge = [28], [4]
    else:
        d_in_node, d_in_edge = [in_features], [in_edge_features]
    degree_encoding = (args["degree_encoding"] if args["degree_as_tag"]
                       else None)
    id_encoding = (args["id_encoding"] if args["id_encoding"] != "None"
                   else None)
    graphs, _e, d_id, _ed, d_degree = encode(graphs, id_encoding,
                                             degree_encoding)
    cfg = _model_config(args, num_classes, in_features, in_edge_features,
                        d_in_node, d_in_edge, d_id, d_degree)
    out, at = {}, 0
    for n in names:
        out[n] = graphs[at:at + len(splits[n])]
        at += len(splits[n])
    return args, out, cfg, list(cfg.d_in_id)


def trainer(args: Dict, model_cfg, train: List[Dict], device):
    from gsn_tpu_torch.cli import trainer_config
    from gsn_tpu_torch.train.loop import Trainer
    return Trainer(model_cfg, trainer_config(args), train, device=device)


def epoch(trainer, state, splits: Dict[str, List[Dict]], logger):
    t = trainer
    t.tcfg.num_epochs = state.epoch + 1
    state, _hist = t.fit(
        state, splits["train"], splits["test"], graphs_val=splits["val"],
        checkpoint_file=None, log_fn=None, logger=logger)
    return state


def hyper(flags: Dict[str, str]) -> Dict:
    """The CLI's ``--lr``, ``--regularization`` (Adam's L2 weight decay;
    its default 0) and ``--batch_size``."""
    return {"lr": float(flags["--lr"]),
            "weight_decay": float(flags.get("--regularization", 0)),
            "batch_size": int(flags["--batch_size"])}
