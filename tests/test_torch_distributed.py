"""Separately launched processes (``gsn_tpu_torch/parallel/
distributed.py`` and the CLI's multi-process flags) against the
reference package and the port's own spawned ranks, on the CPU.

- the per-process feeding: each rank's shard equals the port's
  ``make_global_batch(rank=r)`` / ``make_ep_batch(rank=r)`` and the
  reference's rows;
- two processes started with ``subprocess.Popen`` (this file, run as a
  script, is the worker) join one gloo group through
  ``tcp://127.0.0.1:<port>`` and take 3 dp and 3 ep train steps of a
  small zinc model from the reference's weights, held to ``gsn_tpu``'s
  ``DataParallelTrainer`` / ``EdgePartitionedTrainer`` on a 2-device
  mesh at the tolerances of tests/test_multiprocess.py:130-132: losses
  rtol 1e-4, the first step's gradients rtol 2e-3 / atol 1e-4·max|g|,
  the parameters after 3 steps rtol 3e-3.  The model with BN (its
  moments all-reduced over the ranks) is held to the first step's loss
  and gradients; the 3 steps run the model without BN, as
  tests/test_torch_parallel.py's fits do: Adam turns the noise gradient
  of a bias ahead of a BN into lr-sized steps of either sign, and three
  such steps move the loss by more than 1e-4;
- two ``python -m gsn_tpu_torch.cli`` processes with the multi-process
  flags on the TU toy set from a cold cache, against ``--parallel dp
  --parallel_devices 2`` (spawned by ``parallel.launch``) bit for bit.

Every wait on a process has its own timeout, and on a failure the
other processes are killed.  The module imports no JAX at its top, and
the workers check that they never loaded it.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

from gsn_tpu_torch.config import GSNConfig  # noqa: E402
from gsn_tpu_torch.data.synthetic import make_zinc_like  # noqa: E402
from gsn_tpu_torch.graphs.batching import iterate_batches  # noqa: E402
from gsn_tpu_torch.parallel import (DataParallelTrainer,  # noqa: E402
                                    EdgePartitionedTrainer, distributed,
                                    make_ep_batch, make_global_batch)
from gsn_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from gsn_tpu_torch.params import load_flax_variables  # noqa: E402

NUM_GRAPHS = 16
DP_CAPS = (256, 512, 8)
EP_CAPS = (512, 1024, 16)
LR = 1e-3
STEPS = 3
# seconds a test waits on each process it started
WAIT_S = 180


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(argv_of, n):
    """Start ``n`` processes (``argv_of(i)`` each) from the repository
    root with the port on the path."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return [subprocess.Popen(argv_of(i), cwd=ROOT, env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for i in range(n)]


def wait_all(procs):
    """(stdout, stderr) of each process, each waited on for at most
    WAIT_S seconds; on a timeout or a nonzero exit every process still
    running is killed and the test fails with their output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * len(procs), f"exit codes {rcs}\n" + "\n----\n".join(
        f"{o}\n{e}" for o, e in outs)
    return outs


def zinc(bn=True):
    """(graphs, model kwargs): tests/test_torch_parallel.py's zinc
    model (d=16, 2 layers), with or without BN, on NUM_GRAPHS graphs."""
    sys.path.insert(0, TESTS)
    from test_torch_parallel import zinc_kwargs
    graphs, d_id = make_zinc_like(NUM_GRAPHS)
    return graphs, zinc_kwargs(d_id, bn=bn)


def host_ep_batch(graphs):
    return next(iterate_batches(graphs, len(graphs), caps=EP_CAPS,
                                y_dtype=np.float32))


# ---------------------------------------------------------------------------
# per-process feeding
# ---------------------------------------------------------------------------

def fields_equal(a, b, what):
    for name in ("x", "edge_index", "batch", "y", "node_mask", "edge_mask",
                 "graph_mask", "degrees", "recv_ptr", "send_perm",
                 "send_ptr", "graph_ptr", "in_degree", "identifiers",
                 "edge_features"):
        u, v = getattr(a, name), getattr(b, name)
        u = u.numpy() if isinstance(u, torch.Tensor) else u
        v = v.numpy() if isinstance(v, torch.Tensor) else v
        assert u.dtype == v.dtype, f"{what} {name}"
        np.testing.assert_array_equal(u, v, err_msg=f"{what} {name}")
    assert a.ep_axis == b.ep_axis


@pytest.mark.parametrize("D", [2, 4])
def test_process_shards_match(D):
    """Each rank's ``make_process_dp_batch`` equals ``make_global_batch(
    rank=r)`` and ``shard_stacked_batch`` equals ``make_ep_batch(
    rank=r)``, field for field; the shared fields equal the reference's
    rows; ``fetch_replicated`` reads a batch back to numpy; a rank of
    another axis, or too few graphs, raises."""
    from gsn_tpu.graphs.batching import iterate_batches as jax_batches
    from gsn_tpu.parallel import make_ep_batch as jax_make_ep_batch
    from gsn_tpu.parallel import make_global_batch as jax_global_batch
    graphs, _kw = zinc()
    ref_dp = jax_global_batch(graphs, D, *DP_CAPS, y_dtype=np.float32)
    tb = host_ep_batch(graphs)
    jb = next(jax_batches(graphs, len(graphs), caps=EP_CAPS,
                          y_dtype=np.float32))
    ref_ep = jax_make_ep_batch(jb, D, flow=tb.flow)
    shards = make_ep_batch(tb, D)
    for r in range(D):
        dp_mesh = Mesh("dp", D, r, torch.device("cpu"))
        got = distributed.make_process_dp_batch(graphs, dp_mesh, *DP_CAPS,
                                                y_dtype=np.float32)
        fields_equal(got, make_global_batch(graphs, D, *DP_CAPS,
                                            y_dtype=np.float32, rank=r),
                     f"dp rank {r}")
        for name in ("x", "batch", "y", "node_mask", "graph_mask",
                     "degrees", "identifiers"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(),
                np.asarray(getattr(ref_dp, name)[r]), err_msg=name)
        assert int(got.edge_mask.sum()) == int(
            np.asarray(ref_dp.edge_mask[r]).sum())

        ep_mesh = Mesh("ep", D, r, torch.device("cpu"))
        got = distributed.shard_stacked_batch(shards, ep_mesh)
        fields_equal(got, make_ep_batch(tb, D, rank=r), f"ep rank {r}")
        n = got.num_real_edges
        np.testing.assert_array_equal(
            got.edge_index[:, :n].numpy(),
            np.asarray(ref_ep.edge_index[r])[:, :n])
        for name in ("x", "batch", "node_mask", "degrees", "identifiers",
                     "y", "graph_mask"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(),
                np.asarray(getattr(ref_ep, name)[r]), err_msg=name)
    host = distributed.fetch_replicated({"y": got.y, "t": (got.x,)})
    np.testing.assert_array_equal(host["y"], got.y.numpy())
    assert isinstance(host["t"], tuple)
    np.testing.assert_array_equal(host["t"][0], got.x.numpy())
    with pytest.raises(ValueError, match="mesh axis"):
        distributed.make_process_dp_batch(graphs, ep_mesh, *DP_CAPS)
    with pytest.raises(ValueError, match="graphs per global batch"):
        distributed.make_process_dp_batch(graphs[:D - 1], dp_mesh, *DP_CAPS)


# ---------------------------------------------------------------------------
# two separately launched processes: train steps against the reference
# ---------------------------------------------------------------------------

# steps from the same weights: the model with BN is held to the first
# step, the one without to STEPS steps
RUNS = {"bn": 1, "no_bn": STEPS}


def _steps(trainer, shard, variables, steps):
    """The first step's gradients and ``steps`` steps from
    ``variables``."""
    state = trainer.init_state(seed=0)
    load_flax_variables(state.model, *variables)
    grads = trainer.grads(state, shard)
    load_flax_variables(state.model, *variables)   # undo the BN stats
    losses = [float(trainer.train_step(state, shard, LR)[1])
              for _ in range(steps)]
    return dict(losses=losses,
                grads={k: v.numpy() for k, v in grads.items()},
                state={k: v.numpy() for k, v in
                       state.model.state_dict().items()})


def worker(rank, world, port, job_file, out_dir):
    """One process of the train-step test: join the group, run the dp and
    the ep steps of each model, save the results."""
    with open(job_file, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(1)
    distributed.initialize(f"127.0.0.1:{port}", world, rank,
                           platform="cpu")
    out = {}
    try:
        for run, steps in RUNS.items():
            graphs, kw = zinc(bn=run == "bn")
            mesh = distributed.global_mesh("dp")
            dpt = DataParallelTrainer(GSNConfig(**kw), mesh, lr=LR,
                                      loss_fn="L1Loss")
            shard = distributed.make_process_dp_batch(
                graphs, mesh, *DP_CAPS, y_dtype=np.float32)
            out[run, "dp"] = _steps(dpt, shard, job[run, "dp"], steps)
            mesh = distributed.global_mesh("ep")
            ept = EdgePartitionedTrainer(GSNConfig(**kw), mesh, lr=LR,
                                         loss_fn="L1Loss")
            shard = distributed.shard_stacked_batch(
                make_ep_batch(host_ep_batch(graphs), world), mesh)
            out[run, "ep"] = _steps(ept, shard, job[run, "ep"], steps)
        out["coordinator"] = distributed.is_coordinator()
    finally:
        distributed.shutdown()
    if "jax" in sys.modules:
        raise RuntimeError("the worker loaded JAX")
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def reference_steps(kw, graphs, steps):
    """gsn_tpu's dp and ep trainers on a 2-device mesh: per mode, the
    initial variables (numpy trees) and what ``_steps`` returns."""
    import copy

    import jax
    from gsn_tpu.config import GSNConfig as JaxConfig
    from gsn_tpu.graphs.batching import iterate_batches as jax_batches
    from gsn_tpu.parallel import DataParallelTrainer as JaxDPT
    from gsn_tpu.parallel import EdgePartitionedTrainer as JaxEPT
    from gsn_tpu.parallel import make_ep_batch as jax_make_ep_batch
    from gsn_tpu.parallel import make_global_batch as jax_global_batch
    from gsn_tpu.parallel import make_mesh as jax_make_mesh
    from gsn_tpu_torch.params import flax_to_state_dict
    from test_torch_parallel import numpy_tree

    graphs = copy.deepcopy(graphs)
    jb = next(jax_batches(graphs, len(graphs), caps=EP_CAPS,
                          y_dtype=np.float32))
    runs = {
        "dp": (JaxDPT, ("dp",), jax_global_batch(graphs, 2, *DP_CAPS,
                                                 y_dtype=np.float32)),
        "ep": (JaxEPT, ("ep",), jax_make_ep_batch(jb, 2,
                                                  flow="source_to_target")),
    }
    variables, want = {}, {}
    for mode, (cls, axes, batch) in runs.items():
        tr = cls(JaxConfig(**kw), jax_make_mesh(2, axis_names=axes), lr=LR,
                 loss_fn="L1Loss")
        state = tr.init_state(batch, seed=0)
        variables[mode] = (numpy_tree(state.params),
                           numpy_tree(state.batch_stats))
        grads = flax_to_state_dict(numpy_tree(tr.grads(state, batch)))
        losses = []
        for step in range(steps):
            state, loss = tr.train_step(state, batch, LR,
                                        jax.random.PRNGKey(step))
            losses.append(float(loss))
        want[mode] = dict(losses=losses, grads=grads, state=flax_to_state_dict(
            numpy_tree(state.params), numpy_tree(state.batch_stats)))
    return variables, want


def test_two_processes_match_reference_train_steps(tmp_path):
    """Two gloo processes joined through a coordinator address: the
    first dp and ep step of the model with BN, and 3 dp and 3 ep steps
    of the model without, against gsn_tpu's 2-device trainers; both
    ranks agree bit for bit; only rank 0 is the coordinator."""
    from test_torch_parallel import assert_grads_close
    variables, want = {}, {}
    for run, steps in RUNS.items():
        graphs, kw = zinc(bn=run == "bn")
        v, w = reference_steps(kw, graphs, steps)
        for mode in ("dp", "ep"):
            variables[run, mode], want[run, mode] = v[mode], w[mode]
    job = tmp_path / "job.pkl"
    job.write_bytes(pickle.dumps(variables))
    port = free_port()
    wait_all(start(lambda i: [sys.executable, __file__, str(i), "2",
                              str(port), str(job), str(tmp_path)], 2))
    ranks = [torch.load(tmp_path / f"rank{i}.pt", weights_only=False)
             for i in range(2)]
    assert [r["coordinator"] for r in ranks] == [True, False]
    for key, ref in want.items():
        got = ranks[0][key]
        assert got["losses"] == ranks[1][key]["losses"], key
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4,
                                   err_msg=str(key))
        for r in ranks:
            assert_grads_close(r[key]["grads"], ref["grads"], str(key))
        if key[0] == "bn":
            continue   # held to the first step only (module docstring)
        assert set(got["state"]) == set(ref["state"])
        for name, w in ref["state"].items():
            np.testing.assert_allclose(got["state"][name], w, rtol=3e-3,
                                       err_msg=f"{key} {name}")


# ---------------------------------------------------------------------------
# the CLI's multi-process flags
# ---------------------------------------------------------------------------

def evals(run_dir):
    """The metric records of a CLI run's log.jsonl (the time stamp, the
    seconds, the spans' seconds and the step histogram dropped)."""
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    timed = ("ts", "spans", "step_hist")
    return [{k: v for k, v in r.items()
             if k not in timed and not k.endswith("_s")}
            for r in recs if "train_loss" in r]


def test_cli_processes_match_spawned_ranks(tmp_path):
    """Two ``python -m gsn_tpu_torch.cli`` processes with the
    multi-process flags (no ``--parallel``: dp by default) on the TU toy
    set from a cold cache: both exit 0; the log equals ``--parallel dp
    --parallel_devices 2``'s bit for bit; rank 0 alone wrote the cache,
    the log and the checkpoint and printed; ``--mode test`` and
    ``--resume`` run across the two processes and agree with the
    spawned ranks'."""
    from test_cli import make_tu_dataset
    from test_torch_cli import run, tu_argv
    make_tu_dataset(str(tmp_path))
    cache = tmp_path / "cache"
    assert not cache.exists()

    def processes(*extra):
        port = free_port()
        outs = wait_all(start(lambda i: [
            sys.executable, "-m", "gsn_tpu_torch.cli",
            *tu_argv(tmp_path, "--results_folder", "mp", *extra),
            "--coordinator_address", f"127.0.0.1:{port}",
            "--num_procs_distributed", "2", "--process_id", str(i)], 2))
        assert outs[1][0] == "", outs[1][0]   # rank 1 prints nothing
        return outs[0][0]

    printed = processes()
    assert "defaulting --parallel to 'dp'" in printed
    processed = [f for _d, _s, fs in os.walk(cache / "processed")
                 for f in fs]
    assert len(processed) == 1, processed
    run(tu_argv(tmp_path, "--parallel", "dp", "--parallel_devices", "2",
                "--results_folder", "spawned"))
    mp_dir = cache / "results" / "mp" / "0" / "GSN_sparse"
    sp_dir = cache / "results" / "spawned" / "0" / "GSN_sparse"
    assert [r["step"] for r in evals(mp_dir)] == [0, 7]
    assert evals(mp_dir) == evals(sp_dir)
    assert os.listdir(mp_dir / "checkpoints") == ["checkpoint.pt"]

    tested = run(tu_argv(tmp_path, "--parallel", "dp", "--parallel_devices",
                         "2", "--results_folder", "spawned", "--mode",
                         "test"))[0]
    printed = processes("--mode", "test")
    assert (f"Fold 0: test loss {tested['test_loss']:.4f}, metric "
            f"{tested['test_acc']:.4f}") in printed

    more = ("--resume", "True", "--num_epochs", "15")
    run(tu_argv(tmp_path, "--parallel", "dp", "--parallel_devices", "2",
                "--results_folder", "spawned", *more))
    processes(*more)
    assert [r["step"] for r in evals(mp_dir)] == [0, 7, 14]
    assert evals(mp_dir) == evals(sp_dir)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
           sys.argv[4], sys.argv[5])
