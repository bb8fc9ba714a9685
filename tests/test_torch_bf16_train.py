"""bf16 training steps of the port against the JAX package's, on the CPU: HiFiGAN and the loss dtype.

The rule for ``compute_dtype="bfloat16"`` (here and in ``tests/test_torch_bf16_families.py``): from equal
weights, the same batch and the JAX program's crop start, the test measures the distance of JAX's bf16
step from JAX's fp32 step, and the port's bf16 step may be no farther from JAX's bf16 step than that,
capped at 2e-2 for the losses and 5e-2 for the gradients.  The distance of two steps is two numbers,
the same for both comparisons: the relative L2 distance of their vectors of losses (every
``train/generator/*`` and ``train/discriminator/*`` value the step logs but the grad norms) and of their
gradients (every trained parameter's, generator and discriminators, in one vector).  Both distances
are printed in the assertion message, with each loss's and each model's for reference.  A single small
term cannot carry the rule: on the tiny HiFiGAN and BigVGAN of ``tests/test_torch_train.py``, JAX's own
bf16 step moves its generator gradient by 5.6% and 7.3% and its feature-matching losses by 4e-4 to 8e-4
when the input audio moves by 0.1%, where its fp32 step moves the gradient by 1.9e-3 and 2.1e-4, so two
bf16 programs that round at different places (the port's aa-snake and STFTs compute in fp32 and round
once) differ by that much term by term.

``loss_stft_dtype="bfloat16"`` is a different function in the two packages: the port frames and
transforms the bf16 waveforms in fp32 and rounds the magnitudes (and the loss mel) to bf16, JAX
computes a bf16 DFT.  On the same bf16 waveforms JAX's bf16 DFT moves the spectral convergence, the
log-magnitude loss and the loss mel by 1.6e-4, 3.0e-3 and 1.6e-3 from its fp32 losses; the port's
rounding moves them by 8.9e-5, 6.1e-5 and 1.6e-3 (measured).  So the test holds each loss no farther
from JAX's bf16 than JAX's bf16 is from its fp32 (measured 7.5e-5, 2.9e-3 and 1.2e-3), the spectral
convergence and the mel strictly nearer JAX's bf16 than the port's fp32 losses are (1.6e-4 and
1.6e-3 away), and each loss moved by the field by more than 10x the port's fp32 gap to JAX (2.7e-7,
7.8e-8, 2.6e-8): a port that ignored the field would move none.  The log-magnitude loss cannot tell
the two roundings apart (its port-fp32 distance to JAX's bf16 is 3.0e-3 as well).  The step is held
within JAX's own distance from its fp32-loss step (uncapped; measured: losses 1.27e-3 against 1.30e-3,
gradients 0.36 against 0.42: the bf16 magnitudes' rounding flips the signs of log-magnitude L1 terms,
in either package), and moved by the field from the port's fp32 step by more than 10x the port's fp32
gap to JAX (measured 2.5e-3 and 5.9e-2 against 4.6e-7 and 8.0e-6).  The master parameters and AdamW's
state stay fp32 (the JAX package's own check, ``tests/test_gan_step.py::test_bf16_mixed_precision_train_step``).

K1 under autograd in bf16 (``AASnakeFunction``: on the CPU the plain forward, fp32 inside and one
rounding, and the plain VJP, fp32 sums and bf16 gradients) is held to ``jax.grad`` of the JAX package's
bf16 training aa-snake (``aa_snake_poly4``, XLA's autodiff of bf16 operations) with a tolerance stated
here: dx, d alpha and d beta no farther from JAX's bf16 gradients than those are from JAX's fp32 ones
(measured at (2, 16, 200): 0.87, 0.36 and 0.56 of that distance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import RES, _batch, _configs, _to_jax
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu.losses import multi_resolution_stft_loss as jmr_stft_loss
from vocoder_tpu.ops import antialias as jantialias
from vocoder_tpu.train import gan as jgan
from vocoder_tpu_torch.losses import multi_resolution_stft_loss
from vocoder_tpu_torch.ops.aa_snake import aa_snake
from vocoder_tpu_torch.train import gan

LOSS_CAP, GRAD_CAP = 2e-2, 5e-2
FIELD_MOVES = 10.0  # loss_stft_dtype's effect over the port's fp32 gap to JAX, at least


@pytest.fixture(autouse=True)
def no_onednn():
    """PyTorch's oneDNN bf16 conv2d on the CPU returns wrong values (errors of order 1) where an output is
    one column wide with padding past the input, as the tiny task's MRD has; its native bf16 convs
    (fp32 sums, one rounding) are right, so these tests run without oneDNN."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(tree)])


def jax_step(jcfg, gp, dp, batch: dict, key, extra=None):
    """(losses, generator gradients, discriminator gradients) of the JAX step at ``jcfg``: the two
    functions its ``make_train_step`` differentiates, on its crop."""
    t = batch["audio"].shape[2]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, step_rng = jax.random.split(key)

    @jax.jit
    def run(gp, dp, jbatch, extra):
        mask = jgan.sequence_mask(jbatch["lengths"], t)
        (_, (g_metrics, audio_c, fake_c, _)), grads_g = jax.value_and_grad(jgan._generator_loss, has_aux=True)(
            gp, dp, jbatch["audio"], mask, jcfg, step_rng, extra, jbatch.get("template"))
        (_, d_metrics), grads_d = jax.value_and_grad(jgan._discriminator_loss_fn, has_aux=True)(
            dp, audio_c, fake_c, jcfg)
        return {**g_metrics, **d_metrics}, grads_g, grads_d

    metrics, grads_g, grads_d = run(gp, dp, jbatch, extra)
    return {k: float(v) for k, v in metrics.items()}, grads_g, grads_d


def crop_start(key, t: int, crop_length) -> int | None:
    """The JAX step's crop start: make_train_step splits state.rng, then _generator_loss the step key."""
    if crop_length is None:
        return None
    _, step_rng = jax.random.split(key)
    r_crop, _ = jax.random.split(step_rng)
    return int(jax.random.randint(r_crop, (), 0, t - crop_length))


def loss_keys(metrics: dict) -> list[str]:
    return sorted(k for k in metrics if k.startswith("train/") and "grad_norm" not in k)


def step_distance(got: tuple, want: tuple) -> dict:
    """The distance of two (metrics, generator gradients, discriminator gradients): ``losses`` and
    ``gradients`` (relative L2 of the two vectors), and for reference each loss's relative difference
    and each model's gradient distance."""
    (mg, gg, dg), (mw, gw, dw) = got, want
    keys = loss_keys(mw)
    out = {"losses": rel_l2(np.array([mg[k] for k in keys]), np.array([mw[k] for k in keys])),
           "gradients": rel_l2(np.concatenate([flat(gg), flat(dg)]), np.concatenate([flat(gw), flat(dw)]))}
    out.update({k: rel(mg[k], mw[k]) for k in keys})
    out["gradients/generator"] = rel_l2(flat(gg), flat(gw))
    out.update({f"gradients/{key}": rel_l2(flat(dg[key]), flat(dw[key])) for key in dw})
    return out


def describe(port_vs_jax: dict, floor: dict) -> str:
    return "; ".join(f"{k}: port-vs-jax-bf16 {port_vs_jax[k]:.3e}, jax-bf16-vs-fp32 {floor[k]:.3e}"
                     for k in port_vs_jax)


def assert_within_floor(port_vs_jax: dict, floor: dict, caps=(LOSS_CAP, GRAD_CAP)) -> None:
    """The port's losses and gradients no farther from JAX's bf16 step than JAX's bf16 step is from its fp32
    step, capped (``caps`` None: uncapped, for a tolerance measured and stated)."""
    caps = caps or (np.inf, np.inf)
    bounds = {"losses": min(floor["losses"], caps[0]), "gradients": min(floor["gradients"], caps[1])}
    bad = {k: (port_vs_jax[k], b) for k, b in bounds.items() if not port_vs_jax[k] <= b}
    assert not bad, f"over the bound (distance, bound): {bad}\n{describe(port_vs_jax, floor)}"


def port_step(tcfg, gen_sd: dict, batch: dict, start, to_jax):
    """(metrics, generator grads, discriminator grads) as JAX trees, and the state after the port's step."""
    state = gan.create_train_state(tcfg, 0, "cpu")
    state.generator.load_state_dict(gen_sd)
    metrics = gan.make_train_step(tcfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()}, start)
    grads_g, grads_d = to_jax({n: p.grad for n, p in state.generator.named_parameters()},
                              {n: p.grad for n, p in state.discriminators.named_parameters()})
    return ({k: float(v) for k, v in metrics.items()}, grads_g, grads_d), state


def assert_masters_fp32(state) -> None:
    """The parameters, their gradients and AdamW's moments fp32 after a bf16 step."""
    for module, opt in ((state.generator, state.opt_g), (state.discriminators, state.opt_d)):
        for name, p in module.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
            assert {v.dtype for k, v in opt.state[p].items() if k != "step"} == {torch.float32}, name


def compare(jcfg32, tcfg32, task: dict, gen_sd: dict, to_jax, batch: dict, caps=(LOSS_CAP, GRAD_CAP), extra=None,
            fp32_slack: bool = False, factor: float = 1.0, moves: float | None = None):
    """The port's step under ``task`` against JAX's, with JAX's step at the fp32 configs as the floor.
    ``factor`` times the floor, plus with ``fp32_slack`` the port's fp32 step's own distance from JAX's.
    With ``moves``, ``task`` must also move the port's step from its fp32 step by more than ``moves``
    times that fp32 distance."""
    jcfg, tcfg = jcfg32.replace(**task), tcfg32.replace(**task)
    gp, dp = to_jax(gen_sd, gan.create_train_state(tcfg32, 0, "cpu").discriminators.state_dict())
    key = jax.random.key(3)
    start = crop_start(key, batch["audio"].shape[2], jcfg.crop_length)
    want32 = _jax_step_cached(jcfg32, batch, key, gp, dp, extra)
    want = jax_step(jcfg, gp, dp, batch, key, extra)
    got, state = port_step(tcfg, gen_sd, batch, start, to_jax)
    floor = {k: factor * v for k, v in step_distance(want, want32).items()}
    if fp32_slack or moves:
        got32 = port_step(tcfg32, gen_sd, batch, start, to_jax)[0]
        gap = step_distance(got32, want32)
    if fp32_slack:
        floor = {k: floor[k] + gap[k] for k in floor}
    assert_within_floor(step_distance(got, want), floor, caps)
    if moves:
        moved = step_distance(got, got32)
        assert all(moved[k] > moves * gap[k] for k in ("losses", "gradients")), \
            f"moved from the port's fp32 step {moved}, the port's fp32 step from JAX's {gap}"
    assert_masters_fp32(state)
    return state


_JAX32: dict = {}


def _jax_step_cached(jcfg, batch, key, gp, dp, extra):
    """JAX's fp32 step, computed once a config in this process (the floor of two tests here)."""
    if jcfg not in _JAX32:
        _JAX32[jcfg] = jax_step(jcfg, gp, dp, batch, key, extra)
    return _JAX32[jcfg]


@functools.cache
def hifigan_case():
    """tests/test_gan_step.py's tiny HiFiGAN task (tests/test_torch_train.py's copy): both configs, the
    port's initial generator weights and the bridge."""
    jmod, jcfg, tcfg = _configs("hifigan", True)
    gen_sd = {k: v.clone() for k, v in gan.create_train_state(tcfg, 0, "cpu").generator.state_dict().items()}
    return jcfg, tcfg, gen_sd, lambda g, d: _to_jax(jmod, jcfg, g, d)


def test_hifigan_bf16_step_within_jax_bf16_floor():
    jcfg, tcfg, gen_sd, to_jax = hifigan_case()
    compare(jcfg, tcfg, {"compute_dtype": "bfloat16"}, gen_sd, to_jax, _batch(tcfg))


def test_bf16_loss_waveforms_match_jax():
    """``loss_stft_dtype="bfloat16"``: the losses of the same bf16 waveforms and the step under the rules
    of the module's docstring."""
    jcfg, tcfg, gen_sd, to_jax = hifigan_case()
    rng = np.random.default_rng(4)
    x, y = (np.round(0.3 * rng.standard_normal((2, 128)) * 256) / 256 for _ in range(2))  # exact in bf16

    def port_losses(dtype):
        xt, yt = (torch.from_numpy(a.astype(np.float32)).to(dtype) for a in (x, y))
        sc, mag = multi_resolution_stft_loss(xt, yt, RES)
        return float(sc), float(mag), gan.loss_mel_transform(tcfg, xt).float().numpy()

    def jax_losses(dtype):
        xj, yj = (jnp.asarray(a, dtype) for a in (x, y))
        sc, mag = jmr_stft_loss(xj, yj, RES)
        return float(sc), float(mag), np.asarray(jgan.loss_mel_transform(jcfg, xj).astype(jnp.float32))

    def dist(a, b) -> dict:
        return {"sc": rel(a[0], b[0]), "mag": rel(a[1], b[1]), "mel": rel_l2(a[2], b[2])}

    p16, p32, j16, j32 = port_losses(torch.bfloat16), port_losses(torch.float32), jax_losses(jnp.bfloat16), \
        jax_losses(jnp.float32)
    got, floor, fp32_port, moved, gap = dist(p16, j16), dist(j16, j32), dist(p32, j16), dist(p16, p32), dist(p32, j32)
    readings = f"port16-jax16 {got}, jax16-jax32 {floor}, port32-jax16 {fp32_port}, port16-port32 {moved}, " \
               f"port32-jax32 {gap}"
    assert all(got[k] <= floor[k] for k in got), readings
    assert got["sc"] < fp32_port["sc"] and got["mel"] < fp32_port["mel"], readings
    assert all(moved[k] > FIELD_MOVES * gap[k] for k in moved), readings

    compare(jcfg, tcfg, {"loss_stft_dtype": "bfloat16"}, gen_sd, to_jax, _batch(tcfg), caps=None, moves=FIELD_MOVES)


def test_k1_bf16_vjp_within_jax_bf16_floor():
    shape = b, c, t = (2, 16, 200)
    rng = np.random.default_rng(c + t)
    x, gz = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    alpha, beta = ((0.3 * rng.standard_normal(c)).astype(np.float32) for _ in range(2))

    def jax_grads(dtype):
        def f(x, a, be):
            z = jantialias.aa_snake_poly4(x.astype(dtype).transpose(0, 2, 1), a.astype(dtype), be.astype(dtype), True)
            return jnp.sum(z.astype(jnp.float32) * jnp.asarray(gz).astype(dtype).astype(jnp.float32).transpose(0, 2, 1))
        return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(alpha),
                                                                       jnp.asarray(beta))]

    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, alpha, beta)]
    z = aa_snake(*(v.bfloat16() for v in leaves), True)
    assert z.dtype == torch.bfloat16
    got = [g.numpy() for g in torch.autograd.grad(z, leaves, torch.from_numpy(gz).bfloat16())]
    want, want32 = jax_grads(jnp.bfloat16), jax_grads(jnp.float32)
    dist = {n: (rel_l2(g, w), rel_l2(w, w32)) for n, g, w, w32 in zip(("dx", "d_alpha", "d_beta"), got, want, want32)}
    assert all(d <= floor for d, floor in dist.values()), f"(port-vs-jax-bf16, jax-bf16-vs-fp32): {dist}"


def test_unknown_dtypes_are_refused_by_name():
    _, _, tcfg = _configs("hifigan", True)
    for field in ("compute_dtype", "loss_stft_dtype"):
        with pytest.raises(ValueError, match=f"{field} 'float16': one of 'float32' or 'bfloat16'"):
            gan.make_train_step(tcfg.replace(**{field: "float16"}))
