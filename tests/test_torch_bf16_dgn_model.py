"""The port's bf16 DGNNet against the reference's bf16 DGNNet on the slab
layout, one case per branch of the layer's kernel dispatch (fused,
weighted only, minmax only) and one with a directional derivative and
std's f32 segment path.  Inputs, weights and tolerances as in
``tests/test_torch_bf16_dgn.py`` (a file of its own so that each stays
short on one test worker).
"""

import jax
import pytest
import torch

from gsn_tpu.nn import dgn as jax_dgn
from gsn_tpu_torch.params import flax_to_state_dict

from test_torch_bf16 import REL, cosine, flat
from test_torch_bf16_dgn import (BF16_SETS, bridged, configs,
                                 masked_square, rel_close)
from test_torch_dgn import OPTIONS, dgn_data, numpy_tree  # noqa: F401


@pytest.mark.parametrize("aggs", list(BF16_SETS))
def test_dgn_net_bf16_matches(dgn_data, aggs):
    """DGNNet in bf16 through the weight bridge against the reference's
    on the slab layout: eval prediction, train prediction and loss, the
    all-parameter gradient cosine and the running BN statistics."""
    jcfg, cfg = configs(BF16_SETS[aggs], dgn_data["avg_d"],
                        **OPTIONS.get(aggs, {}))
    jb = dgn_data["slab"]
    jm = jax_dgn.DGNNet(jcfg)
    v = jm.init(jax.random.PRNGKey(0), dgn_data["plain"], train=False)
    model = bridged(v, cfg)
    tb = dgn_data["ours"]

    model.eval()
    with torch.no_grad():
        got = model(tb)
    assert got.dtype == torch.float32
    rel_close(got, jm.apply(v, jb), "eval")

    def loss(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            train=True, mutable=["batch_stats"])
        return masked_square(out, jb.graph_mask), (out, mutated)

    (jl, (jout, mutated)), jgrads = jax.value_and_grad(
        loss, has_aux=True)(v["params"])
    model.train()
    out = model(tb)
    tl = masked_square(out, tb.graph_mask)
    tl.backward()
    rel_close(out.detach(), jout, "train prediction")
    assert tl.item() == pytest.approx(float(jl), rel=REL)
    want = flax_to_state_dict(numpy_tree(jgrads))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert cosine(flat(grads), flat(want)) > 0.99
    state = model.state_dict()
    for name, ref in flax_to_state_dict(
            {}, numpy_tree(mutated["batch_stats"])).items():
        rel_close(state[name], ref, name)


