"""The ranks' side of ``tests/test_torch_tensor_parallel.py`` and ``tests/test_torch_tensor_parallel_jax.py``:
the configurations, inputs and computations that each gloo rank runs in its own process, and the same
computations as one process for the reference.  It imports the port only (no JAX), so that a rank
starts in seconds.

    python -m tests.torch_tp_ranks cases PLAN OUT      # torchrun's variables set: PLAN's cases, OUT/rank<r>.pt

PLAN is a JSON object: ``weights`` (a torch file of {config name: whole state_dict}, which the test made
from the JAX package's parameters), ``model_parallel``, and ``cases``, a list of {kind, name, ...}:
``forward`` (an eval-mode forward, weight norm folded, as ``cli.infer`` runs it), ``step`` (one
training step on the whole batch, tensor parallel only; ``save``: the state after it, and a one-process
checkpoint restored), ``dp_step`` (one step of the (data, model) grid, each model group on its rows of the
global batch), ``drift`` (a ``step`` whose ranks' backwards differ in the gradients of what they hold whole),
``storage_step`` and ``storage_forward`` (``STORAGE``'s generators without explicit specs, every module
storage-sharded at ``STORAGE_MIN_SIZE``: a step as ``step``, with the state's bytes held; an eval forward, weight
norm folded, as ``cli.infer.load_generator`` builds it) and ``storage_checkpoint`` (a one-process checkpoint
restored into a storage-sharded state and gathered back).  The ranks form ``make_grid(model_parallel)``'s grid: model groups of consecutive ranks;
a ``forward`` or ``step`` case runs in every model group on the whole batch, with no data parallelism.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from vocoder_tpu_torch.models import bigvgan, convnext, firefly, hifigan, mpd, mrd, refinegan, vae, vocos, vq, wavenet
from vocoder_tpu_torch.models.convnext import ConvNeXtConfig
from vocoder_tpu_torch.models.registry import get_generator
from vocoder_tpu_torch.nn import fold_weight_norm
from vocoder_tpu_torch.parallel import dist, tp
from vocoder_tpu_torch.train import gan
from vocoder_tpu_torch.train.schedule import WarmupCosineConfig

SEED = 3
HOP = 4
# 256 channels at conv_pre: the first stage (128) shards, the second (64) and conv_post replicate, so each
# kind of layer and both transitions (shard -> shard, shard -> whole) run.  Two blocks a stage: K2's mean.
UPSAMPLER = dict(hop_length=HOP, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 5),
                 resblock_dilation_sizes=((1, 2), (1, 2)), num_mels=8, upsample_initial_channel=256)
VOCOS_HOP = 8
VOCOS_SMALL = dict(dims=(16, 32), depths=(1, 1), n_fft=32)  # the JAX package's vocos TP test's backbone
RES = ((16, 4, 16), (32, 8, 32))
TASK = dict(sampling_rate=8000, n_fft=16, hop_length=HOP, win_length=16, num_mels=8, stft_resolutions=RES,
            num_frames=32)
VOCOS_TASK = dict(sampling_rate=8000, n_fft=32, hop_length=VOCOS_HOP, win_length=32, num_mels=8,
                  stft_resolutions=RES, num_frames=16)
MPD = dict(periods=(2, 3), channels=(1, 4, 8))
SCHEDULE = dict(val_base=2e-4, max_decay_steps=1000)
# Mel frames of the forward cases; the shorter item's first stage keeps the 32 samples under which the JAX
# package's masked aa-snake splices its edges otherwise (tests/test_torch_masked.py).
FRAMES = 24
DP_BATCH = 4  # the global batch of the dp_step cases
PERTURB = 2.0**-8  # the drift case's relative change of a replicated gradient per model rank
# Storage sharding: generators without explicit specs at small widths, every tensor of at least STORAGE_MIN_SIZE
# elements stored in shards (most convs of the generator and the discriminators, the codebook; the small ones
# whole); {case: (registry name, family)}.
STORAGE = {"refinegan": ("refinegan", "gan"), "vae": ("vae", "vae"), "vqvae": ("vqvae", "vqvae"),
           "firefly": ("firefly_gan_base", "gan")}
STORAGE_MIN_SIZE = 256
STORAGE_MPD = dict(periods=(2, 3), channels=(1, 16, 32))
STORAGE_DEC = dict(hop_length=HOP, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
                   resblock_dilation_sizes=((1, 2),), upsample_initial_channel=32)
PORT_MODULES = dict(convnext=convnext, firefly=firefly, hifigan=hifigan, refinegan=refinegan, vae=vae, vq=vq,
                    wavenet=wavenet)


def storage_generator_config(name: str, m: dict = PORT_MODULES):
    """A ``STORAGE`` case's generator config from one package's modules ``m`` (the port's, or the JAX package's
    of the same names)."""
    bins = TASK["n_fft"] // 2 + 1
    if name == "refinegan":
        return m["refinegan"].RefineGANConfig(sampling_rate=8000, hop_length=HOP, downsample_rates=(2, 2),
                                              upsample_rates=(2, 2), num_mels=8, start_channels=8)
    if name == "vae":
        return m["vae"].VAEGeneratorConfig(
            latent_size=8, encoder_kind="convnext",
            encoder=m["convnext"].ConvNeXtConfig(input_channels=bins, depths=(1, 1), dims=(16, 16)),
            decoder=m["hifigan"].HiFiGANConfig(num_mels=8, **STORAGE_DEC))
    if name == "vqvae":
        return m["vae"].VQVAEGeneratorConfig(
            latent_size=16,
            encoder=m["wavenet"].PosteriorEncoderConfig(in_channels=bins, out_channels=16, hidden_channels=16,
                                                        kernel_size=3, n_layers=2),
            decoder=m["hifigan"].HiFiGANConfig(num_mels=16, **STORAGE_DEC), vq=m["vq"].VQConfig(dim=16, codebook_size=32))
    return m["firefly"].FireflyConfig(
        backbone=m["convnext"].ConvNeXtConfig(input_channels=8, depths=(1, 1), dims=(16, 32)),
        head=m["hifigan"].HiFiGANConfig(num_mels=32, pre_conv_kernel_size=13, post_conv_kernel_size=13, **STORAGE_DEC))


def generator_config(name: str):
    """The generator configs of the cases: ``hifigan``, ``bigvgan``, their ``_template`` variants, ``bigvgan_remat``
    (activation checkpointing: the backward runs each AMP block's collectives again),
    ``vocos_huge`` (vocos-huge's widths 352 ... 2816 at depth (1, 1, 1, 1)), ``vocos`` (small) and
    ``vocos_drop`` (small, drop_path 0.5)."""
    if name.startswith(("hifigan", "bigvgan")):
        cls = hifigan.HiFiGANConfig if name.startswith("hifigan") else bigvgan.BigVGANConfig
        return cls(**UPSAMPLER, use_template=name.endswith("_template"), checkpointing=name.endswith("_remat"))
    if name == "vocos_huge":
        huge = vocos.VocosConfig.huge(num_mels=8)
        return vocos.VocosConfig(backbone=ConvNeXtConfig(**{**huge.backbone.__dict__, "depths": (1, 1, 1, 1)}),
                                 head=huge.head)
    if name in ("vocos", "vocos_drop"):
        n_fft, dims = VOCOS_SMALL["n_fft"], VOCOS_SMALL["dims"]
        return vocos.VocosConfig(
            backbone=ConvNeXtConfig(input_channels=8, depths=VOCOS_SMALL["depths"], dims=dims,
                                    drop_path_rate=0.5 if name == "vocos_drop" else 0.0),
            head=vocos.ISTFTHeadConfig(dim=dims[-1], n_fft=n_fft, hop_length=VOCOS_HOP, win_length=n_fft))
    raise ValueError(name)


def model_name(name: str) -> str:
    return name.split("_")[0]


def task_config(name: str, crop: bool = True) -> gan.GANTaskConfig:
    """The tiny GAN task of a step case (tests/test_torch_train.py's discriminators and losses)."""
    if name in STORAGE:
        generator_name, family = STORAGE[name]
        return gan.GANTaskConfig(generator_name=generator_name, generator=storage_generator_config(name),
                                 family=family, input_transform="mel" if family == "gan" else "linear",
                                 crop_length=HOP * 8, mpd=mpd.MPDConfig(**STORAGE_MPD), mrd=mrd.MRDConfig(resolutions=RES),
                                 schedule=WarmupCosineConfig(**SCHEDULE), **TASK)
    kw = VOCOS_TASK if name.startswith("vocos") else TASK
    return gan.GANTaskConfig(generator_name=model_name(name), generator=generator_config(name),
                             crop_length=kw["hop_length"] * 8 if crop else None, mpd=mpd.MPDConfig(**MPD),
                             mrd=mrd.MRDConfig(resolutions=RES), schedule=WarmupCosineConfig(**SCHEDULE), **kw)


def mel_input(name: str, batch: int = 2) -> dict:
    """A forward case's inputs: a log-mel-like (B, num_mels, FRAMES); ``lengths`` (FRAMES, FRAMES - 7) for
    HiFiGAN and BigVGAN (the forward with them runs on the mel zeroed past each); a template of two sines
    for the template variants."""
    cfg = storage_generator_config(name) if name in STORAGE else generator_config(name)
    num_mels = cfg.backbone.input_channels if name.startswith(("vocos", "firefly")) else cfg.num_mels
    rng = np.random.default_rng((SEED, len(name)))
    mel = (rng.standard_normal((batch, num_mels, FRAMES)) - 1.0).astype(np.float32)
    out = {"mel": mel}
    if name in ("hifigan", "bigvgan"):
        out["lengths"] = np.array([FRAMES, FRAMES - 7], np.int64)
    if getattr(cfg, "use_template", False):
        t = np.arange(FRAMES * HOP) / 8000.0
        out["template"] = np.stack([0.1 * np.sin(2 * np.pi * f * t) for f in (300.0, 410.0)])[:, None, :]
        out["template"] = out["template"].astype(np.float32)
    return out


def step_batch(name: str, step: int = 0, batch: int = 2) -> dict:
    """A step case's batch: noise at 0.3, item 1 cut 17 samples short (zero past it), and for a template
    generator a template of two sines; numpy."""
    task = task_config(name)
    t = task.hop_length * task.num_frames
    rng = np.random.default_rng((SEED, step, batch))
    audio = (0.3 * rng.standard_normal((batch, 1, t))).astype(np.float32)
    lengths = np.full(batch, t, np.int64)
    lengths[1] = t - 17
    audio[1, :, t - 17 :] = 0.0
    out = {"audio": audio, "lengths": lengths}
    if gan.needs_template(task):
        tt = np.arange(t) / task.sampling_rate
        out["template"] = np.stack([0.1 * np.sin(2 * np.pi * (300.0 + 37 * i) * tt) for i in range(batch)])[:, None]
        out["template"] = out["template"].astype(np.float32)
    return out


def rows(x, index: int, count: int):
    b = x.shape[0] // count
    return x[index * b : (index + 1) * b]


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().float().cpu().numpy().copy() for k, v in tensors.items()}


def forward_model(name: str, sd: dict, model_group=None) -> torch.nn.Module:
    """The case's generator with the whole weights ``sd``, weight norm folded, then this rank's shard of
    them (``model_group``), in eval mode: ``cli.infer.load_generator``'s order."""
    gen = get_generator(model_name(name))
    model = gen.module_cls(generator_config(name))
    model.load_state_dict(sd)
    fold_weight_norm(model)
    tp.shard_module(model, gen.param_specs(model.cfg), model_group)
    return model.eval()


def run_forward(name: str, sd: dict, model_group=None) -> dict:
    """The forward of ``mel_input(name)``, and with its lengths and its template where it has them; twice
    (the second forward must reuse K2's gathered stage weights: ``tp.whole_blocks``' counts).  BigVGAN's then
    runs once more after a fp32 -> bf16 -> fp32 round trip of the model, which keeps every ``_version``: the
    gathered stages must be made again, from the rounded weights."""
    model = forward_model(name, sd, model_group)
    inp = {k: torch.from_numpy(v) for k, v in mel_input(name).items()}
    kw = {"template": inp["template"]} if "template" in inp else {}
    out, counts = {}, {}

    def counted(key: str, before: tuple) -> None:
        counts[key] = (tp.whole_stages.builds - before[0], tp.whole_stages.hits - before[1])

    before = (tp.whole_stages.builds, tp.whole_stages.hits)
    with torch.inference_mode():
        out["audio"] = model(inp["mel"], **kw)
        out["audio_again"] = model(inp["mel"], **kw)
        if "lengths" in inp:
            out["audio_lengths"] = model(inp["mel"] * mask(inp["lengths"], FRAMES), frame_lengths=inp["lengths"], **kw)
    counted("whole_blocks", before)
    if name.startswith("bigvgan"):
        model.to(torch.bfloat16).to(torch.float32)
        before = (tp.whole_stages.builds, tp.whole_stages.hits)
        with torch.inference_mode():
            out["audio_round_trip"] = model(inp["mel"], **kw)
        counted("whole_blocks_round_trip", before)
    result = {**_numpy(out), **counts}
    if tp.is_sharded(model):
        result["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    return result


def mask(lengths: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, 1, frames): 1 inside each item's length, 0 past it (the CLI's right zero padding)."""
    return (torch.arange(frames)[None, None, :] < lengths[:, None, None]).float()


def train_state(name: str, sd: dict, model_group=None) -> gan.TrainState:
    """The case's TrainState from SEED (the discriminators), the generator's weights ``sd`` (whole),
    sharded over ``model_group``."""
    state = gan.create_train_state(task_config(name), SEED, "cpu", model_group)
    state.generator.load_state_dict(tp.shard_state(state.generator, sd))
    return state


def run_step(name: str, sd: dict, start, index: int = 0, count: int = 1, model_group=None, data_group=None,
             global_batch: int = 2, perturb: bool = False) -> dict:
    """One step of the case on rows ``index`` of ``count`` of the global batch, in the grid's groups:
    metrics, the whole gradients (the generator's gathered), and the whole state after it.  ``perturb``:
    each rank's backward gives every parameter that the ranks hold whole a gradient scaled by
    1 + PERTURB * (its model rank), as a backward that is not bitwise deterministic would differ."""
    task = task_config(name)
    state = train_state(name, sd, model_group)
    if perturb:
        scale = 1.0 + PERTURB * model_group.rank
        sharded = getattr(state.generator, "tp_params", {})
        for module, names in ((state.generator, sharded), (state.discriminators, {})):
            for n, p in module.named_parameters():
                if n not in names:
                    p.register_hook(lambda g: g * scale)
    batch = {k: rows(torch.from_numpy(v), index, count) for k, v in step_batch(name, 0, global_batch).items()}
    metrics = gan.make_train_step(task, group=data_group)(state, batch, start)
    grads = tp.whole_state_dict(state.generator, {n: p.grad for n, p in state.generator.named_parameters()})
    whole = state.state_dict()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _numpy({**{f"generator.{k}": v for k, v in grads.items()},
                             **{f"discriminators.{n}": p.grad for n, p in state.discriminators.named_parameters()}}),
            "state": _numpy({**{f"generator.{k}": v for k, v in whole["generator"].items()},
                             **{f"discriminators.{k}": v for k, v in whole["discriminators"].items()}}),
            "opt_g": whole["opt_g"], "_state": state}


def checkpoint_round_trip(name: str, sd: dict, one_process: Path, model_group) -> dict:
    """A one-process checkpoint (``one_process``, ``TrainState.state_dict()`` of a step) restored into a
    sharded state, then that state's whole ``state_dict()``: what it gives back, and this rank's shard; and
    restored weights only (``run.resume_weights_only``): the shard, the step and a fresh optimizer."""
    ckpt = torch.load(one_process, weights_only=False)
    state = train_state(name, sd, model_group)
    state.load_state_dict(ckpt)
    whole = state.state_dict()
    fresh = train_state(name, sd, model_group)
    fresh.load_state_dict(ckpt, weights_only=True)
    return {"generator": _numpy(whole["generator"]), "opt_g": whole["opt_g"], "step": whole["step"],
            "shard": _numpy(state.generator.state_dict()),
            "weights_only": {"shard": _numpy(fresh.generator.state_dict()), "step": fresh.step,
                             "opt_g_state": len(fresh.opt_g.state_dict()["state"])}}


def storage_state(name: str, model_group=None) -> gan.TrainState:
    return gan.create_train_state(task_config(name), SEED, "cpu", model_group, min_size=STORAGE_MIN_SIZE)


def held(state: gan.TrainState) -> dict:
    """The bytes this rank holds of each part of the state: the generator's and discriminators' parameters, their
    AdamW moments, and the generator's buffers (the codebooks)."""
    g, d = tp.held_bytes(state.generator, state.opt_g), tp.held_bytes(state.discriminators, state.opt_d)
    return {"generator": g["parameters"], "discriminators": d["parameters"], "opt_g": g["moments"],
            "opt_d": d["moments"], "buffers": g["buffers"]}


def run_storage_step(name: str, start, model_group=None) -> dict:
    """One step of a ``STORAGE`` case on its batch, every module storage-sharded over ``model_group``: metrics,
    the whole gradients, the whole state after it (``state``: weights and buffers; ``ckpt``: the whole
    ``state_dict()``, both optimizers' moments included), the bytes held and the number of sharded tensors by
    module."""
    task = task_config(name)
    state = storage_state(name, model_group)
    batch = {k: torch.from_numpy(v) for k, v in step_batch(name).items()}
    metrics = gan.make_train_step(task)(state, batch, start)
    grads = {f"{key}.{k}": v for key, module in (("generator", state.generator), ("discriminators", state.discriminators))
             for k, v in tp.whole_state_dict(module, {n: p.grad for n, p in module.named_parameters()}).items()}
    whole = state.state_dict()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": _numpy(grads),
            "state": _numpy({**{f"generator.{k}": v for k, v in whole["generator"].items()},
                             **{f"discriminators.{k}": v for k, v in whole["discriminators"].items()}}),
            "ckpt": whole, "held": held(state),
            "sharded": {key: len(getattr(m, "tp_params", {})) for key, m in (("generator", state.generator),
                                                                              ("discriminators", state.discriminators))},
            "_state": state}


def run_storage_forward(name: str, sd: dict, model_group=None) -> dict:
    """The eval forward of a ``STORAGE`` case's generator with the whole weights ``sd``, weight norm folded and
    storage-sharded (``cli.infer.load_generator``'s order), twice; the parameter bytes held."""
    cfg = storage_generator_config(name)
    model = get_generator(STORAGE[name][0]).module_cls(cfg)
    model.load_state_dict(sd)
    model = tp.storage_shard(fold_weight_norm(model), model_group, STORAGE_MIN_SIZE).eval()
    mel = torch.from_numpy(mel_input(name)["mel"])
    with torch.inference_mode():
        out = _numpy({"audio": model(mel), "audio_again": model(mel)})
    out["param_bytes"] = tp.held_bytes(model)["parameters"]
    out["sharded"] = len(getattr(model, "tp_params", {}))
    return out


def storage_checkpoint(name: str, one_process: Path, model_group) -> dict:
    """A one-process checkpoint of a ``STORAGE`` case restored into a storage-sharded state: its whole
    ``state_dict()`` back, and this rank's shard of the generator and the discriminators."""
    ckpt = torch.load(one_process, weights_only=False)
    state = storage_state(name, model_group)
    state.load_state_dict(ckpt)
    whole = state.state_dict()
    return {"whole": whole, "shard": {key: _numpy(getattr(state, key).state_dict())
                                      for key in ("generator", "discriminators")}}


def _cases(plan_path: Path, out: Path) -> None:
    torch.set_num_threads(1)
    plan = json.loads(plan_path.read_text())
    dist.init_from_env("cpu")
    grid = tp.make_grid(plan["model_parallel"])
    weights = torch.load(plan["weights"], weights_only=True)
    results = {}
    for case in plan["cases"]:
        name, key = case["name"], f"{case['kind']}/{case['name']}"
        if case["kind"] == "forward":
            results[key] = run_forward(name, weights[name], grid.model)
        elif case["kind"] == "step":
            r = run_step(name, weights[name], case["start"], model_group=grid.model)
            if case.get("save"):
                state = r["_state"]
                results[f"checkpoint/{name}"] = checkpoint_round_trip(name, weights[name], Path(case["save"]),
                                                                      grid.model)
                del state
            results[key] = r
        elif case["kind"] == "drift":
            results[key] = run_step(name, weights[name], case["start"], model_group=grid.model, perturb=True)
        elif case["kind"] == "storage_step":
            results[key] = run_storage_step(name, case["start"], grid.model)
        elif case["kind"] == "storage_forward":
            results[key] = run_storage_forward(name, weights[name], grid.model)
        elif case["kind"] == "storage_checkpoint":
            results[key] = storage_checkpoint(name, Path(case["save"]), grid.model)
        elif case["kind"] == "dp_step":
            results[key] = run_step(name, weights[name], case["start"], grid.data_rank, grid.data_size, grid.model,
                                    grid.data, DP_BATCH)
        else:
            raise ValueError(case["kind"])
        results[key].pop("_state", None)
    torch.save(results, out / f"rank{dist.rank()}.pt")
    dist.close()


if __name__ == "__main__":
    if sys.argv[1] != "cases":
        raise SystemExit(f"unknown mode {sys.argv[1]!r}: cases")
    _cases(Path(sys.argv[2]), Path(sys.argv[3]))
