"""The port's training loss and step (`launch.steps`, `models.api`'s
losses) against the reference's, for the six families of
`tests/test_fused_loss.py` in float32 REDUCED, with the same parameters
and the same batch (`data.make_batch`, bit-equal to the reference's); the
parameters are the port's random ones (seed 0), carried to the
reference as they are.

- `chunked_cross_entropy` equals `cross_entropy` of the full logits and
  the reference's chunked CE (rtol 1e-5, the reference test's), and the
  aux losses agree.
- One `make_train_step`: its loss against the reference's loss (ce +
  0.01 aux, `jax.value_and_grad` of the reference's train step's loss) at
  rtol 1e-5; the gradients (`steps.loss_and_grads`) per leaf within 1e-4
  of max|g_ref| (both float32; the frameworks sum in different orders,
  and a layer's gradient goes through every later layer); the step's
  grad_norm at rtol 1e-4.
The MoE's reference runs with ROADMAP C5 repaired
(`test_torch_moe._c5_free_dispatch`), as the serving tests run it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import api as japi
from repro.models import moe as jmoe

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, adamw_init
from test_torch_moe import _c5_free_dispatch

F32 = dict(param_dtype="float32", activation_dtype="float32")
FAMILIES = ["qwen3-1.7b", "mamba2-130m", "qwen3-moe-30b-a3b",
            "llava-next-mistral-7b", "whisper-medium", "zamba2-2.7b"]
CE_RTOL = 1e-5
GRAD_TOL = 1e-4             # max|g - g_ref| / max|g_ref|, per leaf


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several workers at once,
    and this file's many small ops on every core's thread each slow all
    of them down (the loss test took 11 s alone, ~670 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_cache = {}


def _setup(name):
    """(jcfg, cfg, port params, port batch, reference results): the port's
    random parameters (seed 0) carried to the reference as they are, the
    batch each package's `make_batch` makes (bit-equal), and the
    reference's train-step loss (`launch.steps.make_train_step`'s fused
    loss_fn), its gradient by `jax.value_and_grad`, its chunked CE at
    chunk 8 and its aux loss, from one jitted call."""
    if name not in _cache:
        jcfg = dataclasses.replace(jconfigs.get_reduced(name), **F32)
        cfg = dataclasses.replace(configs.get_reduced(name), **F32)
        shape = ShapeConfig("t", 32, 2, "train")
        params = api.init(0, cfg, shape, device="cpu")
        jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
        jbatch = jmake_batch(jcfg, JShape("t", 32, 2, "train"))
        batch = make_batch(cfg, shape, device="cpu")
        labels, mask = japi.loss_targets(jcfg, jbatch)

        def loss_fn(p):
            feats, aux = japi.forward_features(p, jcfg, jbatch)
            ce = japi.chunked_cross_entropy(p, jcfg, feats, labels, mask)
            ce8 = japi.chunked_cross_entropy(p, jcfg, feats, labels, mask,
                                             max_chunk=8)
            return ce + steps.AUX_LOSS_WEIGHT * aux, (ce8, aux, mask)

        (loss, (ce8, aux, mask)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(jparams)
        _cache[name] = (jcfg, cfg, params, batch,
                        dict(loss=loss, grads=grads, ce8=ce8, aux=aux,
                             mask=mask))
    return _cache[name]


@pytest.fixture
def c5_free(monkeypatch):
    monkeypatch.setattr(jmoe, "_dispatch_group", _c5_free_dispatch)


@pytest.mark.parametrize("name", FAMILIES)
def test_chunked_ce_equals_full_and_reference(name, c5_free):
    jcfg, cfg, params, batch, ref = _setup(name)
    labels, mask = api.loss_targets(cfg, batch)
    with torch.no_grad():
        logits, aux1 = api.forward(params, cfg, batch)
        full = api.cross_entropy(logits, labels, mask)
        feats, aux2 = api.forward_features(params, cfg, batch)
        fused = api.chunked_cross_entropy(params, cfg, feats, labels, mask,
                                          max_chunk=8)
    np.testing.assert_allclose(float(fused), float(full), rtol=CE_RTOL)
    np.testing.assert_allclose(float(aux1), float(aux2), rtol=CE_RTOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref["mask"]))
    np.testing.assert_allclose(float(fused), float(ref["ce8"]), rtol=CE_RTOL)
    np.testing.assert_allclose(float(aux2), float(ref["aux"]), rtol=CE_RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_reference(name, c5_free):
    jcfg, cfg, params, batch, ref = _setup(name)
    want_loss, want_grads = ref["loss"], ref["grads"]
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    new_params, opt, m = steps.make_train_step(cfg, opt_cfg)(
        params, adamw_init(params), batch)
    np.testing.assert_allclose(float(m["loss"]), float(want_loss),
                               rtol=CE_RTOL)
    assert int(opt.step) == 1
    assert jax.tree.structure(new_params) == jax.tree.structure(params)
    (loss, _, _), grads = steps.loss_and_grads(params, cfg, batch)
    assert float(loss) == float(m["loss"])
    flat, _ = jax.tree_util.tree_flatten_with_path(want_grads)
    assert len(flat) == len(jax.tree.leaves(grads))
    sq = 0.0
    for path, w in flat:
        g = grads
        for k in path:
            g = g[k.key]
        w = np.asarray(w, np.float32)
        sq += float(np.sum(np.square(w.astype(np.float64))))
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), \
            (jax.tree_util.keystr(path), err, np.abs(w).max())
    np.testing.assert_allclose(float(m["grad_norm"]), np.sqrt(sq),
                               rtol=1e-4)
