"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for the card and
skips inside it where there is none, so every worker collects the same tests.
Run them on an H100 with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
fp32 comparisons run with TF32 off, so the plain versions are full fp32.
"""

import numpy as np
import pytest
import torch

from vocoder_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig, random_state_dict
from vocoder_tpu_torch.nn import fold_weight_norm
from vocoder_tpu_torch.ops.aa_snake import aa_snake, aa_snake_bwd_kernel, aa_snake_kernel
from vocoder_tpu_torch.ops.amp_block import amp_stage, amp_stage_kernel, amp_stage_plain, stage_plan
from vocoder_tpu_torch.ops.antialias import aa_snake_plain, aa_snake_plain_vjp, snake_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernels have no CPU mode")
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


# bf16 stage against the plain stage that rounds the same conv inputs to bf16:
# what is left is the order of fp32 sums and rare bf16 rounding flips.
K2_BF16_REL_L2 = 1e-3


def _model(cfg, device, dtype=torch.float32):
    m = BigVGAN(cfg)
    m.load_state_dict(random_state_dict(cfg, seed=0))
    return fold_weight_norm(m).to(device=device, dtype=dtype).eval().requires_grad_(False)


NARROW = BigVGANConfig(hop_length=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), num_mels=8,
                       upsample_initial_channel=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 16, 4096), (3, 16, 1500), (2, 8, 37), (1, 5, 1),
    (1, 16, 3967), (1, 16, 3969),  # one below and one above the 3968-output tile
    (2, 16, 12004), (1, 16, 15936),  # bulk-copied tiles between edge tiles (rows 16-byte aligned in fp32; both)
    (2, 8, 100),  # T no multiple of the 31-output run
    (3, 4, 11),  # T under the 12-sample halo
    (1, 70000, 8),  # B * C > 65535 rows
])
def test_aa_snake_kernel_matches_plain(cuda_device, shape, dtype):
    """K1 against the plain version: fp32 within FMA rounding, bf16 within its output rounding.  The
    shapes reach the tile's edges, the bulk copy and the clamped fill, partial runs and a 1-D grid
    over more rows than a 2-D grid's y could take."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    alpha = (0.3 * torch.randn(shape[1], device=cuda_device, generator=gen)).to(dtype)
    beta = (0.3 * torch.randn(shape[1], device=cuda_device, generator=gen)).to(dtype)
    before = aa_snake.launches
    got = aa_snake(x, alpha, beta, True)
    assert aa_snake.launches == before + 1
    want = aa_snake_plain(x, *snake_params(alpha, beta, True))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)  # fp32, FMAs against separate roundings
    else:
        assert _rel_l2(got.float(), want.float()) <= 2e-2  # bf16 output rounding


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
def test_amp_stage_kernel_matches_plain(cuda_device, stage, dtype):
    model = _model(NARROW, cuda_device, dtype)
    blocks = list(model.resblocks[3 * stage : 3 * stage + 3])
    c = NARROW.upsample_initial_channel // 2 ** (stage + 1)
    x = torch.randn(2, c, 300 * (stage + 1), device=cuda_device).to(dtype)
    counter = "launches" if dtype == torch.float32 else "mma_launches"
    before = getattr(amp_stage, counter)
    got = amp_stage(blocks, x, NARROW.snake_logscale)
    assert getattr(amp_stage, counter) == before + 18
    want = amp_stage_plain(blocks, x, NARROW.snake_logscale)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)  # tests/test_amp_fused.py:66
    else:
        assert _rel_l2(got.float(), want.float()) <= K2_BF16_REL_L2


@pytest.mark.parametrize("batch", [1, 160])
@pytest.mark.parametrize("c", [16, 32, 48, 64, 128, 192, 256])
def test_amp_stage_kernel_channel_tiles(cuda_device, c, batch):
    """fp32 through the 3xTF32 route, every channel class's tiles: C = 48 pads
    its 64-column warp grid and takes 16-channel weight chunks, C = 128 takes
    8-channel chunks beside its widest halo, C = 192 and 256 split the small
    tile's output channels into groups of 128 (the second one partial at 192),
    and C = 256's large tile takes one block an SM; T = 333 is no multiple of
    any time tile; b1 takes the small-tile variant, b160 the large one."""
    cfg = BigVGANConfig(hop_length=4, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), num_mels=8,
                        upsample_initial_channel=2 * c)
    blocks = list(_model(cfg, cuda_device).resblocks[:3])
    x = torch.randn(batch, c, 333, device=cuda_device)
    before = amp_stage.launches
    got = amp_stage_kernel(blocks, x, True)
    assert amp_stage.launches == before + 18
    torch.testing.assert_close(got, amp_stage_plain(blocks, x, True), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("batch", [1, 160])
@pytest.mark.parametrize("c", [48, 192, 256])
def test_amp_mma_kernel_channel_tiles(cuda_device, c, batch):
    """bf16 through the tensor-core kernel: C = 48 pads its 64-column warp grid,
    C = 192 pads the 256-column one, C = 256 fills it; T = 333 is no multiple of
    any time tile; b1 takes the small-tile variant, b160 the large one."""
    cfg = BigVGANConfig(hop_length=4, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), num_mels=8,
                        upsample_initial_channel=2 * c)
    blocks = list(_model(cfg, cuda_device, torch.bfloat16).resblocks[:3])
    x = torch.randn(batch, c, 333, device=cuda_device).to(torch.bfloat16)
    before = amp_stage.mma_launches
    got = amp_stage_kernel(blocks, x, True)
    assert amp_stage.mma_launches == before + 18
    assert _rel_l2(got.float(), amp_stage_plain(blocks, x, True).float()) <= K2_BF16_REL_L2


def test_amp_stage_routes_by_model_dtype(cuda_device):
    """fp32 models take the kernel's 3xTF32 route (counter ``launches``), bf16 models its bf16 route
    (``mma_launches``); a bf16 model also takes an fp32 x (the residual stream's dtype)."""
    for dtype, x_dtype, counter in ((torch.float32, torch.float32, "launches"),
                                    (torch.bfloat16, torch.bfloat16, "mma_launches"),
                                    (torch.bfloat16, torch.float32, "mma_launches")):
        blocks = list(_model(NARROW, cuda_device, dtype).resblocks[:3])
        x = torch.randn(1, 32, 200, device=cuda_device).to(x_dtype)
        counts = amp_stage.launches, amp_stage.mma_launches
        with torch.inference_mode():
            got = amp_stage(blocks, x, True)
        moved = amp_stage.launches - counts[0], amp_stage.mma_launches - counts[1]
        assert moved == ((18, 0) if counter == "launches" else (0, 18))
        assert got.dtype == x_dtype
        tol = 1e-5 if dtype == torch.float32 else K2_BF16_REL_L2
        assert _rel_l2(got.float(), amp_stage_plain(blocks, x, True).float()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weight_cache_follows_in_place_changes(cuda_device, dtype):
    """Both routes pack each conv's weights once per model; an in-place change rebuilds the pack."""
    blocks = list(_model(NARROW, cuda_device, dtype).resblocks[:3])
    x = torch.randn(1, 32, 200, device=cuda_device).to(dtype)
    with torch.inference_mode():
        first = amp_stage(blocks, x, True)
        plan = stage_plan(blocks, True)
        assert stage_plan(blocks, True) is plan
    with torch.no_grad():
        blocks[1].convs2[2].weight.mul_(-1.5)
    with torch.inference_mode():
        second = amp_stage(blocks, x, True)
        assert stage_plan(blocks, True) is not plan
        want = amp_stage_plain(blocks, x, True)
    if dtype == torch.float32:
        torch.testing.assert_close(second, want, rtol=2e-4, atol=2e-5)
    else:
        assert _rel_l2(second.float(), want.float()) <= K2_BF16_REL_L2
    assert _rel_l2(second.float(), first.float()) > 1e-2


def test_kernels_refuse_autograd(cuda_device):
    """The kernels are forward only: with gradients on, K2's wrapper and a direct K1 launch raise instead of
    returning a tensor without a graph.  K1 under autograd goes through ``AASnakeFunction`` (tests below)."""
    model = _model(NARROW, cuda_device).requires_grad_(True)
    x = torch.randn(1, 32, 64, device=cuda_device)
    with pytest.raises(RuntimeError, match="forward only"):
        amp_stage(list(model.resblocks[:3]), x, True)
    post = model.activation_post.activation
    with pytest.raises(RuntimeError, match="forward only"):
        aa_snake_kernel(torch.randn(1, 16, 64, device=cuda_device), post.alpha, post.beta, True)


def test_amp_stage_refuses_bf16_input_with_fp32_model(cuda_device):
    """fp32 models take fp32 x only (the 3xTF32 route); a bf16 x needs a bf16 model."""
    model = _model(NARROW, cuda_device)
    x = torch.randn(1, 32, 64, device=cuda_device).to(torch.bfloat16)
    with torch.inference_mode(), pytest.raises(ValueError, match="bf16 model"):
        amp_stage(list(model.resblocks[:3]), x, True)


def test_generator_kernel_path_matches_plain_path(cuda_device):
    model = _model(NARROW, cuda_device)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 40)).astype(np.float32) - 3.0)
    mel = mel.to(cuda_device)
    with torch.inference_mode():
        got, want = model(mel), model.forward_plain(mel)
    assert got.shape == (2, 1, 640)
    assert _rel_l2(got, want) <= 1e-4


def _lengths_past_zero(got, lengths):
    for i, n in enumerate(lengths):
        assert not got[i, :, n:].any(), (i, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aa_snake_kernel_with_lengths_matches_masked_plain(cuda_device, dtype):
    """K1 with per-item lengths: 0, 1, under the 12-sample halo, one below and one above the
    3968-output tile (a bulk-copied tile whose window would cross L takes the clamped loads), T; the
    padding holds values the kernel must not read.  Exactly 0 past each length."""
    lengths = [8000, 0, 1, 7, 3967, 3969, 7936 + 9]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(len(lengths), 16, 8000, device=cuda_device, generator=gen).to(dtype)
    alpha = (0.3 * torch.randn(16, device=cuda_device, generator=gen)).to(dtype)
    beta = (0.3 * torch.randn(16, device=cuda_device, generator=gen)).to(dtype)
    lens = torch.tensor(lengths, device=cuda_device)
    before = aa_snake.launches
    got = aa_snake(x, alpha, beta, True, lens)
    assert aa_snake.launches == before + 1
    want = aa_snake_plain(x, *snake_params(alpha, beta, True), lens)
    _lengths_past_zero(got, lengths)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        assert _rel_l2(got.float(), want.float()) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1])
def test_amp_stage_kernel_with_lengths_matches_masked_plain(cuda_device, stage, dtype):
    """K2, both routes, with per-item lengths: 0, 1, under the halo, one below and one above the time
    tile, T; blocks past an item's length write zeros without their main loop."""
    from vocoder_tpu_torch.ops.amp_block import launch_shape

    model = _model(NARROW, cuda_device, dtype)
    blocks = list(model.resblocks[3 * stage : 3 * stage + 3])
    c, t = NARROW.upsample_initial_channel // 2 ** (stage + 1), 900
    tile, _ = launch_shape(dtype, c, 6, t)
    lengths = [t, 0, 1, 7, tile - 1, tile + 1]
    x = torch.randn(len(lengths), c, t, device=cuda_device).to(dtype)
    lens = torch.tensor(lengths, device=cuda_device, dtype=torch.int32)
    counter = "launches" if dtype == torch.float32 else "mma_launches"
    before = getattr(amp_stage, counter)
    with torch.inference_mode():
        got = amp_stage(blocks, x, NARROW.snake_logscale, lens)
    assert getattr(amp_stage, counter) == before + 18
    want = amp_stage_plain(blocks, x, NARROW.snake_logscale, lens)
    _lengths_past_zero(got, lengths)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    else:
        assert _rel_l2(got.float(), want.float()) <= K2_BF16_REL_L2


def test_generator_padded_batch_equals_per_item_runs(cuda_device):
    """A narrow BigVGAN's padded batch on the kernels: row i, cut to its frames, is item i's own
    forward (rel L2 1e-5, fp32 sums in other orders), and 0 after."""
    model = _model(NARROW, cuda_device)
    lengths = [40, 3, 1, 17, 33]
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal((5, 8, 40)).astype(np.float32) - 3.0)
    for i, n in enumerate(lengths):
        mel[i, :, n:] = 0.0
    mel = mel.to(cuda_device)
    with torch.inference_mode():
        out = model(mel, torch.tensor(lengths, device=cuda_device))
        for i, n in enumerate(lengths):
            alone = model(mel[i : i + 1, :, :n])
            assert _rel_l2(out[i : i + 1, :, : n * 16], alone) <= 1e-5, i
        _lengths_past_zero(out, [n * 16 for n in lengths])


def test_cli_at_pytorch_tf32_defaults_equals_tf32_off(cuda_device, tmp_path, monkeypatch):
    """cli.infer.main turns TF32 off itself: with PyTorch's default flags (cuDNN TF32 on) it writes
    the WAVs it writes with both flags off."""
    from vocoder_tpu_torch.cli import infer
    from vocoder_tpu_torch.config import GANTaskConfig
    from vocoder_tpu_torch.data.audio_io import read_wav

    task = GANTaskConfig(sampling_rate=8000, n_fft=64, hop_length=16, win_length=64, num_mels=8,
                         generator_name="bigvgan", generator=NARROW)
    monkeypatch.setattr(infer, "build_task_config", lambda model, resolution: task)
    torch.save({"state_dict": {f"generator.{k}": v for k, v in random_state_dict(NARROW, 0).items()}},
               tmp_path / "g.ckpt")
    (tmp_path / "in").mkdir()
    rng = np.random.default_rng(3)
    for n in (30, 47):
        np.save(tmp_path / "in" / f"m{n}.npy", (rng.standard_normal((8, n)) - 3.0).astype(np.float32))
    wavs = {}
    for name, flags in (("default", (True, False)), ("off", (False, False))):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        infer.main(["--model", "bigvgan", "--resolution", "tiny", "--ckpt", str(tmp_path / "g.ckpt"), "--input",
                    str(tmp_path / "in"), "--output", str(tmp_path / name), "--batch", "2"])
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        wavs[name] = {p.name: read_wav(p)[0] for p in sorted((tmp_path / name).iterdir())}
    assert list(wavs["default"]) == ["m30.wav", "m47.wav"]
    for key, wav in wavs["default"].items():
        np.testing.assert_array_equal(wav, wavs["off"][key])


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("t", [3967, 3969, 7, 65536])  # K1's 3968-output tile +- 1, under the halo, a training crop
@pytest.mark.parametrize("c", [16, 256, 512])
def test_k1_under_autograd_matches_plain_autograd(cuda_device, c, t, batch):
    """``aa_snake`` with gradients on runs K1 forward (one launch) and the backward kernel (one call): dx
    within rel L2 1e-5 and the parameter gradients (sums over B * T) within 1e-4 of autograd through the
    plain version, from the same upstream gradient."""
    gen = torch.Generator(device=cuda_device).manual_seed(c + t + batch)
    alpha = (0.3 * torch.randn(c, device=cuda_device, generator=gen)).requires_grad_(True)
    beta = (0.3 * torch.randn(c, device=cuda_device, generator=gen)).requires_grad_(True)
    x = torch.randn(batch, c, t, device=cuda_device, generator=gen).requires_grad_(True)
    gz = torch.randn(batch, c, t, device=cuda_device, generator=gen)
    before = aa_snake.launches
    z = aa_snake(x, alpha, beta, True)
    assert aa_snake.launches == before + 1
    before = aa_snake.bwd_launches
    got = torch.autograd.grad(z, (x, alpha, beta), gz)
    assert aa_snake.bwd_launches == before + 1
    want = torch.autograd.grad(aa_snake_plain(x, *snake_params(alpha, beta, True)), (x, alpha, beta), gz)
    assert _rel_l2(got[0], want[0]) <= 1e-5
    assert _rel_l2(got[1], want[1]) <= 1e-4
    assert _rel_l2(got[2], want[2]) <= 1e-4


# The backward kernel against ``aa_snake_plain_vjp`` on the same inputs.  fp32: the same function in FMAs and
# other sum orders (dx ~1e-7 apart; the parameter gradients are sums over B * 2T).  bf16: both compute in fp32
# and round once, so they part only where the two fp32 values straddle a bf16 rounding: dx in a few elements,
# each parameter gradient by at most one bf16 step (2^-7 of it).
BWD_LIMITS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-3, 1e-2)}
BWD_TILE = 1274  # csrc/aa_snake_bwd.cu: kThreads * kRun - 6 outputs a block


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("t", [1, 2, 7, BWD_TILE - 1, BWD_TILE + 1, 65536])  # under the halo, the tile's edges
@pytest.mark.parametrize("c", [16, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aa_snake_bwd_kernel_matches_plain_vjp(cuda_device, dtype, c, t, batch, shard):
    """The backward kernel's (dx, d alpha, d beta) against the plain VJP's, one count of
    ``aa_snake.bwd_launches`` a call, each in the plain VJP's dtype; with ``shard`` the upstream gradient is
    a channel shard's view (the second half of a 2C-channel tensor), as tensor parallelism hands it."""
    gen = torch.Generator(device=cuda_device).manual_seed(c + t + batch)
    params = [torch.exp(0.3 * torch.randn(c, device=cuda_device, generator=gen)).to(dtype) for _ in range(2)]
    wide = 2 * c if shard else c
    x = torch.randn(batch, wide, t, device=cuda_device, generator=gen).to(dtype)[:, wide - c :].contiguous()
    gz = torch.randn(batch, wide, t, device=cuda_device, generator=gen).to(dtype)[:, wide - c :]
    assert gz.is_contiguous() == (not shard or batch == 1)  # one item's shard is a contiguous slice
    before = aa_snake.bwd_launches
    got = aa_snake_bwd_kernel(x, *params, gz)
    assert aa_snake.bwd_launches == before + 1
    want = aa_snake_plain_vjp(x, *params, gz)
    dx_limit, param_limit = BWD_LIMITS[dtype]
    assert [g.dtype for g in got] == [w.dtype for w in want] == [dtype] * 3
    assert _rel_l2(got[0].float(), want[0].float()) <= dx_limit
    for g, w in zip(got[1:], want[1:]):
        assert _rel_l2(g.float(), w.float()) <= param_limit


def test_aa_snake_bwd_kernel_refuses_a_second_derivative(cuda_device):
    """The backward kernel builds no graph: a backward with ``create_graph`` raises instead of returning
    gradients that autograd cannot differentiate."""
    x = torch.randn(1, 16, 64, device=cuda_device, requires_grad=True)
    alpha, beta = (torch.zeros(16, device=cuda_device, requires_grad=True) for _ in range(2))
    z = aa_snake(x, alpha, beta, True)
    with pytest.raises(RuntimeError, match="second derivative"):
        torch.autograd.grad(z, x, torch.ones_like(z), create_graph=True)


def _tiny_task(name):
    from vocoder_tpu_torch.config import build_task_config
    from vocoder_tpu_torch.models.mpd import MPDConfig
    from vocoder_tpu_torch.models.mrd import MRDConfig

    gen = dict(hop_length=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), num_mels=8,
               upsample_initial_channel=64, resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3)))
    task = build_task_config(name)
    res = ((64, 16, 64), (32, 8, 32))
    return task.replace(sampling_rate=8000, n_fft=64, win_length=64, hop_length=16, num_mels=8, num_frames=32,
                        crop_length=128, generator=type(task.generator)(**gen),
                        mpd=MPDConfig(periods=(2, 3), channels=(1, 4, 8)), mrd=MRDConfig(resolutions=res),
                        stft_resolutions=res)


def test_train_step_kernel_path_matches_plain_path(cuda_device):
    """A tiny BigVGAN training step with K1 under autograd against the same step through the plain
    versions, from the same weights, batch and crop: every loss within rel 1e-5, the grad norms 1e-4,
    every generator gradient rel L2 1e-3; K1 and its backward run once per activation of the forward."""
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.train import gan

    task = _tiny_task("bigvgan")
    batch = synthetic_batch(2, 512, 8000, 0, cuda_device)
    runs = []
    for plain in (False, True):
        state = gan.create_train_state(task, 0, cuda_device)
        before = aa_snake.launches, aa_snake.bwd_launches
        metrics = gan.make_train_step(task, plain=plain)(state, batch, 100)
        launched = aa_snake.launches - before[0], aa_snake.bwd_launches - before[1]
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.detach().clone() for n, p in state.generator.named_parameters()}, launched))
    (mk, gk, nk), (mp, gp, npl) = runs
    # K1 and its backward: 2 stages x 2 blocks x 2 dilations x 2, and activation_post
    assert nk == (2 * 2 * 2 * 2 + 1,) * 2 and npl == (0, 0)
    for key in mk:
        limit = 1e-4 if "grad_norm" in key else 1e-5
        assert abs(mk[key] - mp[key]) <= limit * max(abs(mp[key]), 1e-30), key
    for name in gk:
        assert _rel_l2(gk[name], gp[name]) <= 1e-3, name


def test_eval_step_follows_optimizer_updates(cuda_device):
    """Validation after training steps: AdamW changes the weight-norm parameters
    (``parametrizations.weight.original0/1``) in place, and K2's packed weights must follow.  The eval
    step's fake (K2 stages, built into a plan before the updates) equals the plain forward on the
    updated weights within rel L2 1e-4, and the updates (lr 1e-2) moved it by more than 1e-2."""
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.train import gan
    from vocoder_tpu_torch.train.schedule import WarmupCosineConfig

    task = _tiny_task("bigvgan").replace(schedule=WarmupCosineConfig(val_base=1e-2))
    state = gan.create_train_state(task, 0, cuda_device)
    batch = synthetic_batch(2, 512, 8000, 0, cuda_device)
    eval_step = gan.make_eval_step(task)
    _, before = eval_step(state, batch)
    step = gan.make_train_step(task)
    for _ in range(2):
        step(state, batch, 100)
    launches = amp_stage.launches
    _, after = eval_step(state, batch)
    assert amp_stage.launches - launches == 2 * 2 * 2 * 2  # 2 stages x 2 blocks x 2 dilations x 2 convs
    with torch.no_grad():
        want = gan.generator_forward(state.generator, batch["audio"], task, plain=True)[0]
    assert _rel_l2(after, want) <= 1e-4
    assert _rel_l2(after, before) > 1e-2


def _bf16_floor_bound(got, plain, plain32, cap):
    """The bf16 rule of the card checks: the kernel path no farther from the plain bf16 path than twice the
    plain bf16 path is from the plain fp32 path, capped."""
    return _rel_l2(got, plain) <= min(2 * _rel_l2(plain, plain32), cap)


@pytest.mark.parametrize("t", [3969, 65536])
def test_k1_bf16_under_autograd_matches_plain(cuda_device, t):
    """bf16 x, alpha and beta (cast from fp32 leaves, as bf16 training casts them) through ``aa_snake``
    with gradients on: K1's bf16 route forward (one launch, a bf16 output), the backward kernel (fp32
    inside, bf16 gradients; one call).  dx, d alpha and d beta at the fp32 leaves against autograd through the
    plain version on the same bf16 inputs, within twice the plain bf16 gradients' distance from the plain fp32
    ones (capped at 5e-2)."""
    from vocoder_tpu_torch.ops.antialias import snake_params

    c, batch = 256, 2
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    leaves = [(0.3 * torch.randn(c, device=cuda_device, generator=gen)).requires_grad_(True) for _ in range(2)]
    x32 = torch.randn(batch, c, t, device=cuda_device, generator=gen).requires_grad_(True)
    gz = torch.randn(batch, c, t, device=cuda_device, generator=gen)

    def grads(fn, dtype):
        x, alpha, beta = x32.to(dtype), *(p.to(dtype) for p in leaves)
        z = fn(x, alpha, beta)
        return z, torch.autograd.grad(z, (x32, *leaves), gz.to(dtype))

    before = aa_snake.launches, aa_snake.bwd_launches
    z, got = grads(lambda x, a, b: aa_snake(x, a, b, True), torch.bfloat16)
    assert (aa_snake.launches, aa_snake.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert z.dtype == torch.bfloat16

    def plain(x, a, b):
        return aa_snake_plain(x, *snake_params(a, b, True))

    _, want = grads(plain, torch.bfloat16)
    _, want32 = grads(plain, torch.float32)
    for g, w, w32 in zip(got, want, want32):
        assert _bf16_floor_bound(g, w, w32, 5e-2), (_rel_l2(g, w), _rel_l2(w, w32))


def test_bf16_validations_with_changed_weights_match_plain(cuda_device):
    """K2's plan cache against bf16 validation: each eval step under bf16 compute runs a fresh bf16 copy of
    the generator through K2's bf16 route; a second validation after the weights changed (two AdamW steps
    at lr 1e-2) must not run the first copy's packed weights.  Each fake within rel L2 5e-3 of the plain
    bf16 forward of the same weights, and the weights' change moved the fake by more than 10 times that."""
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.train import gan
    from vocoder_tpu_torch.train.schedule import WarmupCosineConfig

    task = _tiny_task("bigvgan").replace(schedule=WarmupCosineConfig(val_base=1e-2), compute_dtype="bfloat16")
    state = gan.create_train_state(task, 0, cuda_device)
    batch = synthetic_batch(2, 512, 8000, 0, cuda_device)
    eval_step, step = gan.make_eval_step(task), gan.make_train_step(task)
    fakes = []
    for _ in range(2):
        launches = amp_stage.mma_launches
        _, fake = eval_step(state, batch)
        assert amp_stage.mma_launches - launches == 2 * 2 * 2 * 2  # K2's bf16 route, 16 convs
        with torch.no_grad():
            copy = gan.eval_generator(state.generator, task).eval()
            want = gan.generator_forward(copy, batch["audio"], task, plain=True)[0]
        assert _rel_l2(fake, want) <= 5e-3
        fakes.append((fake, _rel_l2(fake, want)))
        for _ in range(2):
            step(state, batch, 100)
    assert _rel_l2(fakes[1][0], fakes[0][0]) > 10 * max(fakes[0][1], fakes[1][1])
    assert all(p.dtype == torch.float32 for p in state.generator.parameters())


def test_prefetcher_on_the_card_equals_the_synchronous_copy(cuda_device):
    """``DevicePrefetcher`` onto the card (pinned memory, a side stream) yields, bit for bit, what copying
    the synchronous iterator's batches gives, and each batch is ready on the consumer's stream."""
    from vocoder_tpu_torch.data.dataset import DevicePrefetcher, batch_iterator

    def sample(rng):
        return rng.standard_normal((1, int(rng.integers(3000, 9000)))).astype(np.float32)

    def host():
        return batch_iterator(sample, batch_size=4, target_length=8192, seed=3, num_workers=2)

    want = host()
    pf = DevicePrefetcher(host(), cuda_device)
    try:
        for _ in range(6):
            got, ref = next(pf), next(want)
            assert all(v.is_cuda for v in got.values())
            doubled = got["audio"] * 2  # on the consumer's stream, after the copy
            for k, v in ref.items():
                assert torch.equal(got[k].cpu(), torch.from_numpy(v)), k
            assert torch.equal(doubled.cpu(), torch.from_numpy(ref["audio"]) * 2)
    finally:
        pf.close()
        want.close()
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("upsample_initial_channel", [768])
def test_bigvgan_stages_k2_does_not_take_run_blockwise(cuda_device, upsample_initial_channel):
    """Stage widths 384, 192, 96, 48 and 24: K2 takes the middle three; the first (C > 256) and the last
    (C % 16 != 0) run block by block on K1 and cuDNN, counted, and the forward matches its plain path."""
    cfg = BigVGANConfig(upsample_initial_channel=upsample_initial_channel)
    model = _model(cfg, cuda_device)
    mel = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 128, 12)).astype(np.float32) - 5.0)
    mel = mel.to(cuda_device)
    with torch.inference_mode():
        BigVGAN.blockwise_stages, launches = 0, amp_stage.launches
        got = model(mel)
        assert BigVGAN.blockwise_stages == 2
        assert amp_stage.launches - launches == 3 * 18
        want = model.forward_plain(mel)
    assert got.shape == (2, 1, 12 * 512) and bool(torch.isfinite(got).all())
    assert _rel_l2(got, want) <= 1e-4


NARROW_TEMPLATE = BigVGANConfig(hop_length=16, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), num_mels=8,
                                upsample_initial_channel=64, use_template=True)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_template_generator_kernel_path_matches_plain_path(cuda_device, dtype, masked):
    """BigVGAN with an f0 template (noise convs after each upsample) on K1 and K2 against its plain path,
    with and without frame_lengths: fp32 rel L2 1e-4, bf16 2e-2 (two plain paths that differ only in fp32
    sum order drift ~1e-2 through a bf16 generator); K2 takes every stage (none block by block)."""
    from vocoder_tpu_torch.data.f0 import template_from_f0

    model = _model(NARROW_TEMPLATE, cuda_device, dtype)
    rng = np.random.default_rng(5)
    lengths = [40, 17, 9]
    mel = torch.from_numpy(rng.standard_normal((3, 8, 40)).astype(np.float32) - 3.0)
    tpl = torch.from_numpy(np.stack([template_from_f0(np.full(40, f), 8000, 16) for f in (210.0, 330.0, 450.0)]))
    lens = None
    if masked:
        for i, n in enumerate(lengths):
            mel[i, :, n:] = 0.0
        lens = torch.tensor(lengths, device=cuda_device)
    mel, tpl = mel.to(cuda_device, dtype), tpl[:, None].to(cuda_device, dtype)
    counter = "launches" if dtype == torch.float32 else "mma_launches"
    with torch.inference_mode():
        BigVGAN.blockwise_stages, k1, k2 = 0, aa_snake.launches, getattr(amp_stage, counter)
        got = model(mel, lens, template=tpl)
        assert BigVGAN.blockwise_stages == 0 and aa_snake.launches == k1 + 1
        assert getattr(amp_stage, counter) == k2 + 2 * 18
        want = model.forward_plain(mel, lens, template=tpl)
    assert got.shape == (3, 1, 640) and bool(torch.isfinite(got).all())
    assert _rel_l2(got.float(), want.float()) <= (1e-4 if dtype == torch.float32 else 2e-2)
    if masked:
        _lengths_past_zero(got, [n * 16 for n in lengths])


def test_refinegan_draws_on_the_card_are_reproducible(cuda_device):
    """RefineGAN's AdaIN noise drawn on the card: the same CUDA generator seed gives the same audio,
    another seed other audio, no generator the seeded-0 default; a CPU generator is refused, not copied."""
    from vocoder_tpu_torch.models.refinegan import RefineGAN, RefineGANConfig
    from vocoder_tpu_torch.models.refinegan import random_state_dict as refinegan_weights

    cfg = RefineGANConfig(sampling_rate=8000, hop_length=16, downsample_rates=(2, 2, 2, 2),
                          upsample_rates=(2, 2, 2, 2), num_mels=8, start_channels=4)
    model = RefineGAN(cfg)
    model.load_state_dict(refinegan_weights(cfg, 0))
    model = fold_weight_norm(model).to(cuda_device).eval()
    rng = np.random.default_rng(6)
    mel = torch.from_numpy(rng.standard_normal((2, 8, 24)).astype(np.float32) - 5.0).to(cuda_device)
    tpl = torch.from_numpy(0.1 * np.sin(np.arange(24 * 16) / 5.0)).float().expand(2, 1, -1).to(cuda_device)

    def gen(seed):
        return torch.Generator(device=cuda_device).manual_seed(seed)

    with torch.inference_mode():
        a, b, c = model(mel, tpl, gen(3)), model(mel, tpl, gen(3)), model(mel, tpl, gen(4))
        d, e = model(mel, tpl), model(mel, tpl, gen(0))
        assert torch.equal(a, b) and torch.equal(d, e) and bool(torch.isfinite(a).all())
        assert float((a - c).abs().max()) > 1e-3
        with pytest.raises(RuntimeError):
            model(mel, tpl, torch.Generator().manual_seed(3))


def _tiny_family_task(family: str):
    """A tiny vae (ConvNeXt encoder) or vqvae (WaveNet, 32 codes) task at 8 kHz, hop 16, n_fft 64."""
    from vocoder_tpu_torch.config import apply_overrides, build_task_config

    dec = ["hop_length=16", "upsample_rates=(4,4)", "upsample_kernel_sizes=(8,8)", "upsample_initial_channel=32",
           "resblock_kernel_sizes=(3,)", "resblock_dilation_sizes=((1,3),)", "num_mels=6"]
    enc = (["input_channels=33", "depths=(1,2)", "dims=(8,12)"] if family == "vae"
           else ["in_channels=33", "out_channels=6", "hidden_channels=16", "n_layers=3"])
    over = ["sampling_rate=8000", "n_fft=64", "win_length=64", "hop_length=16", "num_frames=32", "crop_length=128",
            "mpd.periods=(2,3)", "mpd.channels=(1,4,8)", "mrd.resolutions=((64,16,64),(32,8,32))",
            "stft_resolutions=((64,16,64),(32,8,32))", "generator.latent_size=6",
            *[f"generator.decoder.{o}" for o in dec], *[f"generator.encoder.{o}" for o in enc]]
    if family == "vqvae":
        over += ["generator.vq.dim=6", "generator.vq.codebook_size=32"]
    return apply_overrides(build_task_config(family=family), over)


def test_vae_train_step_on_the_card_matches_the_cpu(cuda_device):
    """A tiny vae step on the card against the same step on the CPU: the same weights, batch, crop and
    eps draws (a CPU noise generator on both sides; draws move to the model's device): every loss rel 1e-5,
    every generator gradient rel L2 1e-4, the updated generator within 2 lr of the CPU's."""
    from vocoder_tpu_torch.models.vae import vae_random_state_dict
    from vocoder_tpu_torch.tools.profile_train import synthetic_batch
    from vocoder_tpu_torch.train import gan

    task = _tiny_family_task("vae")
    batch = synthetic_batch(2, 512, 8000, 0, "cpu")
    runs = []
    for device in ("cpu", cuda_device):
        state = gan.create_train_state(task, 0, device)
        state.generator.load_state_dict(vae_random_state_dict(task.generator, 0))
        state.noise = torch.Generator().manual_seed(1)
        metrics = gan.make_train_step(task)(state, {k: v.to(device) for k, v in batch.items()}, 100)
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.detach().cpu() for n, p in state.generator.named_parameters()},
                     {n: p.detach().cpu() for n, p in state.generator.named_parameters()}))
    (mc, gc, pc), (mk, gk, pk) = runs
    for key in mk:
        limit = 1e-4 if "grad_norm" in key else 1e-5
        assert abs(mk[key] - mc[key]) <= limit * max(abs(mc[key]), 1e-30), key
    for name in gc:
        assert _rel_l2(gk[name], gc[name]) <= 1e-4, name
        assert float((pk[name] - pc[name]).abs().max()) <= 2 * mc["lr"] + 1e-6, name


def test_vqvae_codec_round_trip_on_the_card(cuda_device, tmp_path):
    """cli.codec encode and decode on the card over a tiny vqvae workdir (the codebook on latent frames):
    the codes equal encode on the CPU wherever a frame's margin exceeds 1e-4 of its squared norm (most
    frames), and the WAV equals the CPU's decode of the same codes within two 16-bit steps."""
    import dataclasses
    import json

    from vocoder_tpu_torch.cli import codec
    from vocoder_tpu_torch.config import TrainConfig
    from vocoder_tpu_torch.data.audio_io import read_wav, write_wav
    from vocoder_tpu_torch.models.vae import VQVAEGenerator, vqvae_random_state_dict
    from vocoder_tpu_torch.ops.spectral import linear_spectrogram

    task = _tiny_family_task("vqvae")
    rng = np.random.default_rng(7)
    env = np.repeat(rng.uniform(0.0, 0.6, 250), 16)
    audio = (env * rng.standard_normal(env.size)).astype(np.float32)
    (tmp_path / "in").mkdir()
    write_wav(tmp_path / "in" / "a.wav", audio, 8000)
    model = VQVAEGenerator(task.generator)
    model.load_state_dict(vqvae_random_state_dict(task.generator, 0))
    spec = linear_spectrogram(torch.from_numpy(audio)[None], n_fft=64, hop_length=16, win_length=64)
    with torch.no_grad():
        frames = model.encoder(spec)[0].T
        rows = frames[torch.from_numpy(rng.choice(frames.shape[0], 32, replace=False))]
        model.vq.layers[0].embed.copy_(rows + 0.3 * frames.std(0) * torch.randn(rows.shape))
    (tmp_path / "run" / "checkpoints").mkdir(parents=True)
    (tmp_path / "run" / "config.json").write_text(json.dumps(dataclasses.asdict(TrainConfig(task=task)), default=str))
    torch.save({"generator": model.state_dict()}, tmp_path / "run" / "checkpoints" / "1.pt")
    run = str(tmp_path / "run")
    for device, out in ((str(cuda_device), "card"), ("cpu", "cpu")):
        codec.main(["encode", "--ckpt", run, "--input", str(tmp_path / "in"), "--output", str(tmp_path / out),
                    "--device", device])
    codec.main(["decode", "--ckpt", run, "--input", str(tmp_path / "card"), "--output", str(tmp_path / "wav"),
                "--device", str(cuda_device)])
    card, cpu = np.load(tmp_path / "card" / "a.codes.npy"), np.load(tmp_path / "cpu" / "a.codes.npy")
    with torch.no_grad():
        x = model.encoder(spec)[0].T.double()
        d = torch.sort(torch.cdist(x, model.vq.layers[0].embed.double()).square(), dim=1).values
        clear = ((d[:, 1] - d[:, 0]) / x.square().sum(1) > 1e-4).numpy()
        want = model.eval().decode_from_codes(torch.from_numpy(card.astype(np.int64)))[0, 0].numpy()
    assert card.shape == (1, 1, 250) and clear.mean() > 0.8 and len(np.unique(card)) > 8
    np.testing.assert_array_equal(card[0, 0][clear], cpu[0, 0][clear])
    wav, sr = read_wav(tmp_path / "wav" / "a.wav")
    assert sr == 8000 and wav.shape == (1, 4000)
    np.testing.assert_allclose(wav[0], want, rtol=0, atol=2.0 / 32768)
