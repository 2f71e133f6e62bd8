"""The port's AdamW and cosine schedule against the reference's.

Same params, moments and grads from numpy go through both updates.
Tolerance rtol 1e-6 / atol 1e-7: the reference computes the bias
corrections and the learning rate in fp32, the port in float64 Python
scalars, so results differ in the last fp32 bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import AdamWState as JaxState
from repro.optim.adamw import cosine_schedule as jax_cosine
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule

SHAPES = {"embed": (64, 16), "blocks.0.attn.wq": (16, 16),
          "final_norm.scale": (16,)}


def _tree(flat):
    """Flat dotted names -> a nested dict for the reference."""
    out = {}
    for name, v in flat.items():
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3])
def test_adamw_update_matches_reference(grad_scale):
    """grad_scale 10 puts the global norm far above clip_norm (clipping
    active); 1e-3 leaves it below (no clipping)."""
    rng = np.random.default_rng(0)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = {n: (rng.standard_normal(s) * grad_scale).astype(np.float32)
             for n, s in SHAPES.items()}
    m = {n: (rng.standard_normal(s) * 1e-2).astype(np.float32)
         for n, s in SHAPES.items()}
    v = {n: np.abs(rng.standard_normal(s) * 1e-3).astype(np.float32)
         for n, s in SHAPES.items()}
    step = 4
    sched = dict(base_lr=3e-3, warmup=2, total=20)

    jopt = JaxAdamW(lr=jax_cosine(**sched), weight_decay=0.1)
    jstate = JaxState(jnp.asarray(step, jnp.int32), _tree(m), _tree(v))
    jparams, jnew = jopt.update(_tree(grads), jstate, _tree(params))

    opt = AdamW(lr=cosine_schedule(**sched), weight_decay=0.1)
    tparams = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    state = AdamWState(step, {n: torch.from_numpy(a.copy())
                              for n, a in m.items()},
                       {n: torch.from_numpy(a.copy()) for n, a in v.items()})
    new = opt.update({n: torch.from_numpy(a) for n, a in grads.items()},
                     state, tparams)
    assert new.step == int(jnew.step) == step + 1
    for name, want in _flat(jparams).items():
        np.testing.assert_allclose(tparams[name].numpy(), want, rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    for got, want in ((new.m, _flat(jnew.m)), (new.v, _flat(jnew.v))):
        for name in SHAPES:
            np.testing.assert_allclose(got[name].numpy(), want[name],
                                       rtol=1e-6, atol=1e-9, err_msg=name)


def test_cosine_schedule_matches_reference():
    """atol 1e-10 = base_lr x 1e-7: near the end of the schedule the
    reference's fp32 ``1 + cos(pi * prog)`` cancels to a few ulps of 1."""
    ours = cosine_schedule(1e-3, 10, 100)
    ref = jax_cosine(1e-3, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(ours(step),
                                   float(ref(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, atol=1e-10, err_msg=str(step))
