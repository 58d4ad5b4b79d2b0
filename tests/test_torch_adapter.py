"""The port's embedding adapter against the JAX package's.

Same numpy-seeded queries and positives (the positives a random rotation
of the queries, as ``tests/test_parallel.py`` builds them) at dim 16,
hidden 32, batch 8, with the JAX package's initial parameters carried
over by ``convert.adapter_params_from_jax``. Bounds: ``adapter_apply``
max-abs 1e-6 (at the initial weights, and at 50 times them, where the
tanh and erf GELUs part); loss rtol 1e-6; gradients against ``jax.grad`` rtol 1e-5 / atol
1e-7; a 5-step ``optax.adamw(1e-2)`` trajectory against the port's
``adamw`` (``torch.optim.AdamW``) losses rtol 1e-4 / atol 1e-5 and
parameters rtol 1e-4 / atol 1e-5, with the loss falling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hipporag_tpu.models import adapter as ref
from hipporag_tpu_torch.convert import adapter_params_from_jax
from hipporag_tpu_torch.models import adapter as port

torch.set_num_threads(1)

DIM, HIDDEN, B = 16, 32, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    queries = rng.standard_normal((B, DIM)).astype(np.float32)
    rot, _ = np.linalg.qr(rng.standard_normal((DIM, DIM)))
    positives = (queries @ rot.astype(np.float32)).astype(np.float32)
    return queries, positives, ref.init_adapter(jax.random.PRNGKey(0), DIM, HIDDEN)


@pytest.mark.parametrize("scale", [1.0, 50.0])
def test_adapter_apply_matches_jax(data, scale):
    queries, _pos, params = data
    params = ref.AdapterParams(*(p * scale for p in params))
    want = np.asarray(ref.adapter_apply(params, jnp.asarray(queries)))
    got = port.adapter_apply(adapter_params_from_jax(params, "cpu"), torch.from_numpy(queries))
    assert np.abs(got.detach().numpy() - want).max() <= 1e-6
    np.testing.assert_allclose(np.linalg.norm(want, axis=1), 1.0, rtol=1e-5)
    if scale == 50.0:  # the erf GELU would not match here
        p = adapter_params_from_jax(params, "cpu")
        erf = torch.nn.functional.gelu(torch.from_numpy(queries) @ p.w_in + p.b_in)
        tanh = torch.nn.functional.gelu(torch.from_numpy(queries) @ p.w_in + p.b_in, approximate="tanh")
        assert (erf - tanh).abs().max() > 1e-4


def test_loss_and_gradients_match_jax(data):
    queries, positives, params = data
    loss, grads = jax.value_and_grad(ref.info_nce_loss)(params, jnp.asarray(queries), jnp.asarray(positives))
    p = adapter_params_from_jax(params, "cpu")
    got = port.info_nce_loss(p, torch.from_numpy(queries), torch.from_numpy(positives))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-6)
    for name in port.AdapterParams._fields:
        np.testing.assert_allclose(getattr(p, name).grad.numpy(), np.asarray(getattr(grads, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_adamw_trajectory_matches_optax(data):
    queries, positives, params0 = data
    opt = optax.adamw(1e-2)
    step = ref.make_train_step(opt)
    p_ref, s_ref = params0, opt.init(params0)
    ref_losses = []
    for _ in range(5):
        p_ref, s_ref, loss = step(p_ref, s_ref, jnp.asarray(queries), jnp.asarray(positives))
        ref_losses.append(float(loss))

    params = adapter_params_from_jax(params0, "cpu")
    train_step = port.make_train_step(port.adamw(params, 1e-2))
    q, pos = torch.from_numpy(queries), torch.from_numpy(positives)
    losses = [float(train_step(params, q, pos)) for _ in range(5)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-5)
    for name in port.AdapterParams._fields:
        np.testing.assert_allclose(getattr(params, name).detach().numpy(), np.asarray(getattr(p_ref, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert losses[-1] < losses[0]


def test_init_adapter_is_seeded_and_trainable():
    a = port.init_adapter(DIM, HIDDEN, generator=torch.Generator().manual_seed(5), device="cpu")
    b = port.init_adapter(DIM, HIDDEN, generator=torch.Generator().manual_seed(5), device="cpu")
    assert [tuple(t.shape) for t in a] == [(DIM, HIDDEN), (HIDDEN,), (HIDDEN, DIM)]
    assert all(torch.equal(x, y) and x.requires_grad and x.is_leaf for x, y in zip(a, b))
    assert not a.b_in.any() and 0.01 < float(a.w_in.detach().std()) < 0.03
