"""PyTorch port: the adaptive ODE solvers (`ops/odeint.py` `odeint_adaptive`,
`odeint_adaptive_rows`, `odeint(method="adaptive")`) against the JAX
package on analytic flows, float32 on the CPU, and the cached sampler's
tail ODE with `odeint_method="adaptive"` against the JAX one.

The reference caveat of `odeint_adaptive_rows` is matched, not avoided:
its closing Euler step after max_steps runs out is gated batch-wide
(`jnp.any`), so the exhaustion cases below hold the port to that gate."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfusion_tpu.models.transfusion import Transfusion as JaxTransfusion
from transfusion_tpu_torch import Transfusion
from transfusion_tpu_torch.ops import odeint as tode

jode = importlib.import_module("transfusion_tpu.ops.odeint")
torch.set_num_threads(1)
RATES = np.asarray([1.0, 25.0], np.float32)  # row 1 is much stiffer


def close(t, j, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol, rtol=1e-6)


@pytest.mark.parametrize("tol", [1e-5, 1e-6])
def test_odeint_adaptive_matches_jax(tol):
    y0 = np.random.default_rng(0).standard_normal(4).astype(np.float32)
    out_t = tode.odeint(lambda t, y: -y + torch.sin(3.0 * t), torch.tensor(y0),
                        torch.linspace(0, 1, 64), method="adaptive", atol=tol, rtol=tol)
    out_j = jode.odeint(lambda t, y: -y + jnp.sin(3.0 * t), jnp.asarray(y0),
                        jnp.linspace(0, 1, 64), method="adaptive", atol=tol, rtol=tol)
    close(out_t, out_j)
    # dy/dt = -y: y(1) = e^-1
    dec = tode.odeint(lambda t, y: -y, torch.ones(()), torch.linspace(0, 1, 2),
                      method="adaptive", atol=1e-7, rtol=1e-7)
    np.testing.assert_allclose(float(dec), np.exp(-1.0), atol=1e-5)


@pytest.mark.parametrize("max_steps", [1, 3])
def test_odeint_adaptive_step_exhaustion_closes_like_jax(max_steps):
    """max_steps exhaustion: one explicit Euler step carries the state to
    t1, as in the reference (`ops/odeint.py:126-140`)."""
    ones = tode.odeint_adaptive(lambda t, y: torch.ones_like(y), torch.zeros(4), 0.0, 1.0,
                                max_steps=max_steps)
    close(ones, np.ones(4), atol=1e-5)
    y0 = np.random.default_rng(1).standard_normal(3).astype(np.float32)
    out_t = tode.odeint_adaptive(lambda t, y: -4.0 * y + t, torch.tensor(y0), 0.0, 1.0,
                                 max_steps=max_steps)
    out_j = jode.odeint_adaptive(lambda t, y: -4.0 * y + t, jnp.asarray(y0), 0.0, 1.0,
                                 max_steps=max_steps)
    close(out_t, out_j)


@pytest.mark.parametrize("max_steps", [4096, 20])
def test_odeint_adaptive_rows_matches_jax(max_steps):
    """Per-row control against JAX on rows of unequal stiffness; at
    max_steps 20 the stiff row runs out and the batch-wide closing gate
    acts on both rows, in both packages."""
    y0 = np.random.default_rng(2).standard_normal((2, 3)).astype(np.float32)
    rt, rj = torch.tensor(RATES), jnp.asarray(RATES)
    out_t = tode.odeint_adaptive_rows(lambda t, y: -rt[:, None] * y + t[:, None],
                                      torch.tensor(y0), 0.0, 1.0, max_steps=max_steps)
    out_j = jode.odeint_adaptive_rows(lambda t, y: -rj[:, None] * y + t[:, None],
                                      jnp.asarray(y0), 0.0, 1.0, max_steps=max_steps)
    close(out_t, out_j)


def test_odeint_adaptive_rows_placement_invariant():
    """A row integrated beside a stiffer co-tenant gives the bit-identical
    result it gives alone; b = 1 agrees with the scalar controller."""
    rates = torch.tensor(RATES)
    y0 = torch.ones((2, 3))
    joint = tode.odeint_adaptive_rows(lambda t, y: -rates[: y.shape[0], None] * y, y0, 0.0, 1.0)
    for r in range(2):
        alone = tode.odeint_adaptive_rows(lambda t, y, r=r: -rates[r] * y, y0[r:r + 1], 0.0, 1.0)
        assert torch.equal(joint[r], alone[0])
    solo = tode.odeint_adaptive(lambda t, y: -rates[0] * y, y0[0], 0.0, 1.0)
    close(joint[0], solo)
    np.testing.assert_allclose(joint[0].numpy(), np.exp(-1.0) * np.ones(3), atol=1e-3)
    np.testing.assert_allclose(joint[1].numpy(), np.exp(-25.0) * np.ones(3), atol=1e-3)


@pytest.mark.parametrize("rows", [False, True])
def test_odeint_reads_the_device_once_per_iteration(monkeypatch, rows):
    """Each iteration reads one flag back to the host (a tensor's
    `__bool__`), and the closing gate one more; nothing else is read."""
    reads, evals = [], []
    bool_of = torch.Tensor.__bool__

    def counted(self):
        reads.append(1)
        return bool_of(self)

    def fn(t, y):
        evals.append(1)
        return -4.0 * y

    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    solver = tode.odeint_adaptive_rows if rows else tode.odeint_adaptive
    solver(fn, torch.ones((2, 3)), 0.0, 1.0)
    monkeypatch.undo()
    iterations = len(evals) // 2
    assert iterations > 4 and len(reads) == iterations + 2  # + the loop's exit, the gate


def test_cached_sample_adaptive_matches_jax():
    """`sample(cache_kv=True)` with odeint_method='adaptive' (the tail ODE
    of `_ode_cached_impl`) against JAX: greedy tokens equal, latents within
    1e-3 (the controller takes hundreds of steps, which carry the float32
    rounding of two implementations further than a fixed grid does)."""
    cfg = dict(num_text_tokens=8, dim_latent=16, modality_default_shape=(4,), pad_multiple=16,
               odeint_method="adaptive")
    tcfg = dict(dim=32, depth=2, dim_head=32, heads=2, attn_impl="dense")
    jm = JaxTransfusion(transformer=tcfg, **cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = Transfusion(transformer=tcfg, device="cpu", **cfg)
    tm.load_flax(jax.tree.map(np.asarray, params))
    noise = np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32)
    kw = dict(prompt=[np.asarray([1, tm.som_ids[0]], np.int32)], max_length=6, modality_steps=4,
              init_modality_noise=noise, cfg_scale=3.0, text_temperature=0.0,
              cache_kv=True)
    out_j = jm.sample(params, rng=jax.random.PRNGKey(1), return_unprocessed_modalities=True,
                      kv_quantize=False, **kw)
    out_t = tm.sample(**kw)
    assert len(out_t) == len(out_j)
    for a, b in zip(out_t, out_j):
        if isinstance(a, tuple):
            np.testing.assert_allclose(a[1], np.asarray(b[1]), atol=1e-3)
        else:
            np.testing.assert_array_equal(a, np.asarray(b))
