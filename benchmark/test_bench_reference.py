"""The plain reference and the work counters on the CPU: cycle counts
of graphs whose counts are known, the one-hot-unique encoding, the
reference models against the program at a small size, the operations
and bytes of hand-sized shapes, and the imports."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, os.path.join(HERE, "core")]

import registry  # noqa: E402

CYC = registry.module("reference", "ref_cycles")


def graph(n, edges):
    both = sorted([(u, v) for u, v in edges] + [(v, u) for u, v in edges])
    return {"x": np.zeros((n, 1), np.int64),
            "edge_index": np.array(both, np.int64).T}


def test_cycle_counts_of_known_graphs():
    # a 4-cycle with one chord: two triangles, one 4-cycle (not induced)
    g = graph(4, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)])
    nodes = CYC.count_cycles([g], 4, "global", False)[0]
    assert nodes[:, 0].tolist() == [2, 1, 2, 1]          # triangles
    assert nodes[:, 1].tolist() == [1, 1, 1, 1]          # 4-cycles
    edges = CYC.count_cycles([g], 4, "local", True)[0]
    assert (edges[:, 1] == 0).all()                      # chorded
    ei = g["edge_index"].T.tolist()
    chord = [i for i, (u, v) in enumerate(ei) if {u, v} == {0, 2}]
    assert edges[chord, 0].tolist() == [2, 2]
    # K4: 4 triangles, 3 four-cycles; each node in 3 and 3
    k4 = graph(4, [(a, b) for a in range(4) for b in range(a + 1, 4)])
    assert CYC.count_cycles([k4], 4, "global", False)[0].tolist() == \
        [[3, 3]] * 4
    # an 8-cycle and a 6-cycle side by side, counted together
    c8 = graph(8, [(i, (i + 1) % 8) for i in range(8)])
    c6 = graph(6, [(i, (i + 1) % 6) for i in range(6)])
    a, b = CYC.count_cycles([c8, c6], 8, "global", False)
    assert (a[:, 5] == 1).all() and (a[:, :5] == 0).all()
    assert (b[:, 3] == 1).all() and (b[:, 4:] == 0).all()


def test_one_hot_unique():
    enc, dims = CYC.one_hot_unique([np.array([[5, 0], [2, 0]]),
                                    np.array([[9, 1]])])
    assert dims == [3, 2]
    assert enc[0].tolist() == [[1, 0], [0, 0]] and enc[1].tolist() == \
        [[2, 1]]


@pytest.mark.parametrize("workload,sizes", [
    ("zinc-gsn-ef-500k.fit", {"train": 400, "val": 64, "test": 64}),
    ("molhiv-gsn-vn-af.fit", {"train": 128, "val": 64, "test": 32})])
def test_reference_follows_the_program(workload, sizes):
    """The program's set-up steps and its evaluation hold every limit of
    the cell; the first step to round-off."""
    import compare
    import readings
    torch.manual_seed(0)
    out = readings.seed_readings(workload, 2 ** 31 + 5, "cpu", sizes,
                                 faults={})
    n = out["sound"]
    limits = registry.cell(workload)[1]["check"]["limits"]
    checks, ok = compare.judge(n, limits)
    assert ok, checks
    assert n["loss1_gap"] < 1e-5 and n["stats1_gap"] < 1e-5


# compare.check's numbers at the sizes above on one CPU thread (its
# reductions split by the thread count), as commit fcb11be computed them
# before the CLI's code moved into drivers/gsn_cli.py
BEFORE_THE_DRIVERS = {
    "zinc-gsn-ef-500k.fit": {
        "change_gap": 0.031180917317064693,
        "eval_loss_gap": 3.2691217880265474e-07,
        "eval_metric_gap": 3.2691217880265474e-07,
        "eval_row_gap": 3.2691217880265474e-07,
        "grad_gap": 0.0012178849235208234,
        "grad_med_gap": 5.301851568427679e-05,
        "id_mismatch": 0.0,
        "loss1_gap": 0.0,
        "loss_gap": 0.008113735363970878,
        "stats1_gap": 6.357580291532042e-07,
        "stats_gap": 0.007968214578852838},
    "molhiv-gsn-vn-af.fit": {
        "change_gap": 0.004542744525493441,
        "eval_loss_gap": 0.0,
        "eval_metric_gap": 0.0,
        "eval_row_gap": 7.864383633204852e-07,
        "grad_gap": 2.6630462292097595e-05,
        "grad_med_gap": 2.263526663113914e-06,
        "id_mismatch": 0.0,
        "loss1_gap": 8.134086180968451e-08,
        "loss_gap": 0.001623917556150111,
        "mask_keep_gap": 0.008437514305114746,
        "stats1_gap": 5.72483326900844e-07,
        "stats_gap": 0.0018497191562581873}}
# ref_common.train_steps with no weight decay, as fcb11be computed it:
# the three losses and a digest of the first gradients, the parameters
# after and both sets of batch-norm statistics
STEPS_BEFORE = (["0.9129307270050049", "0.9230300784111023",
                 "0.7281273603439331"],
                "4b8bdbb53f3b002cca27626a42d8435d"
                "912b1b4dd5c81cf6028eac4d83a6ccd2")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload,sizes", [
    ("zinc-gsn-ef-500k.fit", {"train": 400, "val": 64, "test": 64}),
    ("molhiv-gsn-vn-af.fit", {"train": 128, "val": 64, "test": 32})])
def test_the_check_reads_as_before_the_drivers(one_thread, workload, sizes):
    """Every number of the check, bit for bit the parent's: the move of
    the CLI's code into its driver changed nothing it computes."""
    import readings
    torch.manual_seed(0)
    out = readings.seed_readings(workload, 2 ** 31 + 5, "cpu", sizes,
                                 faults={})
    assert out["sound"] == BEFORE_THE_DRIVERS[workload]


def _bn_leaves(stats):
    return {f"{n}.{k}": t for n, pair in stats.items()
            for k, t in zip(("mean", "var"), pair)}


def _zinc_steps(weight_decay=None):
    """Three reference steps of a small zinc model on 24 molecules."""
    import hashlib
    common = registry.module("reference", "ref_common")
    ref = registry.module("reference", "zinc-gsn-ef-500k")
    traffic = registry.data("traffic", "zinc-epochs")
    traffic = dict(traffic, data=dict(traffic["data"],
                                      splits={"train": 24}))
    graphs = registry.module("traffic", "molecules").make_splits(
        traffic, 2 ** 33 + 1)["train"]
    ids, dims = CYC.one_hot_unique(CYC.count_cycles(graphs, 8, "global",
                                                    False))
    flags = {"--num_layers": "2", "--d_out": "16"}
    params = common.init_params(ref.spec(flags, dims), 11, "cpu")
    batches = [common.Batch(graphs[k:k + 8], ids[k:k + 8], "cpu")
               for k in range(0, 24, 8)]
    extra = () if weight_decay is None else (weight_decay,)
    losses, first, after, stats1, stats = common.train_steps(
        ref.Model(flags, dims), params, batches, None, 1e-3, 3, *extra)
    h = hashlib.sha256()
    for leaves in (first, after, _bn_leaves(stats1), _bn_leaves(stats)):
        for n in sorted(leaves):
            h.update(n.encode())
            h.update(leaves[n].detach().contiguous().numpy().tobytes())
    return [repr(x) for x in losses], h.hexdigest()


def test_train_steps_without_decay_as_before(one_thread):
    assert _zinc_steps() == STEPS_BEFORE
    assert _zinc_steps(0.0) == STEPS_BEFORE


def test_weight_decay_is_torchs_l2():
    """``train_steps`` with weight decay against torch's Adam (the
    program's optimizer) on a linear model over three steps: the
    parameters after, and the first gradient as the program reads it,
    from Adam's first moment; AdamW's decoupled decay lies far off."""
    from types import SimpleNamespace
    common = registry.module("reference", "ref_common")
    gen = torch.Generator().manual_seed(4)
    p0 = {"w": torch.randn(6, 1, generator=gen),
          "b": torch.randn(1, generator=gen)}
    batches = [SimpleNamespace(x=torch.randn(8, 6, generator=gen),
                               y=torch.randn(8, 1, generator=gen))
               for _ in range(3)]

    class Linear:
        def forward(self, P, stats, b, train, masks):
            return b.x @ P["w"] + P["b"]

        def loss(self, pred, y):
            return ((pred - y) ** 2).mean()

    wd, lr = 0.5, 1e-2

    def torch_run(cls):
        leaves = {n: torch.nn.Parameter(p.clone()) for n, p in p0.items()}
        opt = cls(leaves.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                  weight_decay=wd)
        read = None
        for b in batches:
            opt.zero_grad()
            Linear().loss(Linear().forward(leaves, {}, b, True, None),
                          b.y).backward()
            opt.step()
            if read is None:
                read = {n: opt.state[p]["exp_avg"] / (1 - 0.9)
                        for n, p in leaves.items()}
        return {n: p.detach() for n, p in leaves.items()}, read

    _losses, first, after, _s1, _s = common.train_steps(
        Linear(), p0, batches, None, lr, 3, wd)
    want, read = torch_run(torch.optim.Adam)
    other, _ = torch_run(torch.optim.AdamW)
    for n in p0:
        torch.testing.assert_close(after[n], want[n], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(first[n], read[n], rtol=1e-6, atol=1e-7)
        assert (after[n] - other[n]).abs().max() > 1e-4


def rows(n, e, g):
    return [{"x": np.zeros((n // g, 1)), "edge_index": np.zeros((2, e // g))}
            for _ in range(g)]


def test_work_of_hand_sized_shapes():
    zinc = registry.module("work", "zinc-gsn-ef-500k")
    flags = {"--num_layers": "1", "--d_out": "2"}
    # one layer, d=2, one id column of 3: N=4, E=6, G=2
    f = zinc.model_flops(flags, [3], rows(4, 6, 2), False)
    want = (2 * 2 * 4 * (28 + 3) * 2 + 2 * 6 * 4 * 2 + 2 * 6 * 2 * 2
            + 2 * 4 * (28 + 2) * 2 + 2 * 4 * 2 * 2 + 2 * 2 * 2 * 2
            + 2 * 2 * 2)
    assert f == want
    assert zinc.model_flops(flags, [3], rows(4, 6, 2), True) == 3 * want
    work = dict((n, (fl, b)) for n, fl, b in
                zinc.kernel_work(flags, rows(4, 6, 2), 1, True))
    assert work["receiver_sum"] == (6 * 2, 6 * 2 * 4 + 4 * 4 + 4 * 2 * 4)
    assert work["pool_bwd"] == (0, 2 * 2 * 4 + 2 * 4 + 4 * 2 * 4)
    hiv = registry.module("work", "molhiv-gsn-vn-af")
    flags = {"--num_layers": "2", "--d_out": "3", "--d_h": "5"}
    f = hiv.model_flops(flags, [], rows(4, 6, 2), False)
    assert f == 2 * 2 * 4 * 30 + 1 * 2 * 2 * 30 + 2 * 2 * 3
    names = [n for n, _f, _b in hiv.kernel_work(flags, rows(4, 6, 2), 1,
                                                 False)]
    assert names == ["ogb_message", "vn_broadcast", "pools"]
    peaks = registry.module("work", "peaks")
    assert peaks.least_s(67e12, 0) == 1.0
    assert peaks.least_s(0, 3.35e12) == 1.0


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    """A whole run (on the CPU, at a small size) loads no module whose
    top-level name is JAX's or the JAX package's."""
    code = (
        "import sys, time; sys.path[:0] = ['.', 'benchmark/core'];"
        "import cell; cell.run('zinc-gsn-ef-500k.fit', 3, 0.1, False, "
        "'cpu', time.perf_counter(), sizes={'train': 400, 'val': 32, "
        "'test': 32});"
        "print(' '.join(m.split('.')[0] for m in sys.modules))")
    tops = _modules_after(code)
    assert "gsn_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "gsn_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = ['benchmark/core']; import registry;"
        "[registry.module('reference', n) for n in ('ref_common', "
        "'ref_cycles', 'zinc-gsn-ef-500k', 'molhiv-gsn-vn-af')];"
        "print(' '.join(m.split('.')[0] for m in sys.modules))")
    tops = _modules_after(code)
    assert not tops & {"jax", "jaxlib", "flax", "gsn_tpu", "gsn_tpu_torch"}
    for name in os.listdir(os.path.join(HERE, "reference")):
        with open(os.path.join(HERE, "reference", name)) as f:
            assert "gsn_tpu" not in f.read(), name


@pytest.mark.parametrize("traffic,atoms,bonds", [
    ("zinc-epochs", 23.16, 24.92),      # Dwivedi et al. 2020, Table 1
    ("molhiv-epochs", 25.5, 27.5)])     # Hu et al. 2020, Table 2
def test_molecules_keep_the_published_means(traffic, atoms, bonds):
    """Atoms and bonds per molecule near the dataset's published means,
    rings (bonds - atoms + 1) within 2%, and the same amount of work for
    every seed."""
    mol = registry.module("traffic", "molecules")
    t = registry.data("traffic", traffic)
    t = dict(t, data=dict(t["data"], splits={"train": 3000, "val": 500}))
    sums = []
    for seed in (1, 2 ** 33 + 9):
        gs = [g for s in mol.make_splits(t, seed).values() for g in s]
        n = np.mean([g["x"].shape[0] for g in gs])
        e = np.mean([g["edge_index"].shape[1] / 2 for g in gs])
        assert abs(n - atoms) / atoms < 0.01
        assert abs(e - bonds) / bonds < 0.01
        assert abs((e - n + 1) - (bonds - atoms + 1)) < 0.02 * (
            bonds - atoms + 1)
        sums.append(sum(g["x"].shape[0] for g in gs))
    assert sums[0] == sums[1]
