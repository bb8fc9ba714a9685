"""K1 under autograd (``AASnakeFunction``) against ``jax.grad`` of the JAX package, on the CPU.

On the CPU the Function's forward is the plain version and its backward ``aa_snake_plain_vjp``, the
code the card runs after K1's forward.  The oracle is ``jax.grad`` through the JAX package's unfolded
BigVGAN activation (``models/bigvgan.py::_aa_snake`` in training, the poly4 backend), with the
log-scale parameters' ``exp`` inside, at rtol 2e-4 / atol 2e-5 (the JAX kernel tests' tolerance).
``torch.autograd.gradcheck`` holds the VJP against finite differences of the forward in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vocoder_tpu.models import bigvgan as jbigvgan
from vocoder_tpu_torch.ops.aa_snake import AASnakeFunction, aa_snake
from vocoder_tpu_torch.ops.antialias import aa_snake_plain, snake_params

RTOL, ATOL = 2e-4, 2e-5


@pytest.mark.parametrize("t", [100, 40])  # 40: under the JAX edge splice's two windows
@pytest.mark.parametrize("kind,logscale", [("snakebeta", True), ("snake", False)])
def test_k1_function_backward_matches_jax_grad(kind, logscale, t):
    rng = np.random.default_rng(t)
    c = 6
    x = rng.standard_normal((2, c, t)).astype(np.float32)
    gz = rng.standard_normal((2, c, t)).astype(np.float32)
    base = 0.0 if logscale else 1.0
    p = {"alpha": (base + 0.3 * rng.standard_normal(c)).astype(np.float32)}
    if kind == "snakebeta":
        p["beta"] = (base + 0.3 * rng.standard_normal(c)).astype(np.float32)

    def f(params, xj):  # (B, T, C) channels-last, as the JAX package runs it
        z = jbigvgan._aa_snake(params, xj, logscale, training=True)
        return jnp.sum(z * jnp.asarray(gz.transpose(0, 2, 1)))

    jgrads, jdx = jax.grad(f, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x.transpose(0, 2, 1)))

    xt = torch.from_numpy(x).requires_grad_(True)
    params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    z = aa_snake(xt, params["alpha"], params.get("beta"), logscale)
    z.backward(torch.from_numpy(gz))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx).transpose(0, 2, 1), rtol=RTOL, atol=ATOL)
    for k in p:
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(jgrads[k]), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("t", [1, 2, 9, 30])  # edge folds overlap for T under the 12-sample halo
def test_k1_function_gradcheck_float64(t):
    """The VJP against finite differences of the forward, and against autograd through the plain
    version, in float64 (gradcheck's default tolerances: atol 1e-5, rtol 1e-3)."""
    gen = torch.Generator().manual_seed(t)
    x = torch.randn(2, 3, t, dtype=torch.float64, generator=gen, requires_grad=True)
    alpha = (0.5 + torch.rand(3, dtype=torch.float64, generator=gen)).requires_grad_(True)
    beta = (0.5 + torch.rand(3, dtype=torch.float64, generator=gen)).requires_grad_(True)
    assert torch.autograd.gradcheck(AASnakeFunction.apply, (x, alpha, beta))
    gz = torch.randn(2, 3, t, dtype=torch.float64, generator=gen)
    got = torch.autograd.grad(AASnakeFunction.apply(x, alpha, beta), (x, alpha, beta), gz)
    want = torch.autograd.grad(aa_snake_plain(x, alpha, beta), (x, alpha, beta), gz)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-5)


def test_aa_snake_routes_through_the_function_only_under_autograd():
    """Gradients on and a parameter that needs them: the Function; otherwise the plain forward with no graph.
    Per-item lengths under autograd are refused, not silently dropped."""
    x = torch.randn(1, 4, 20)
    alpha, beta = torch.zeros(4, requires_grad=True), torch.zeros(4, requires_grad=True)
    z = aa_snake(x, alpha, beta, True)
    assert z.grad_fn is not None and "AASnakeFunction" in type(z.grad_fn).__name__
    with torch.no_grad():
        assert aa_snake(x, alpha, beta, True).grad_fn is None
    torch.testing.assert_close(z.detach(), aa_snake_plain(x, *snake_params(alpha, beta, True)).detach())
    with pytest.raises(NotImplementedError, match="lengths"):
        aa_snake(x, alpha, beta, True, torch.tensor([10]))
