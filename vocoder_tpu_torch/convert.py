"""Weights bridge: JAX parameter trees and reference checkpoints -> port state_dicts.

``bigvgan_state_dict_from_jax``, ``hifigan_state_dict_from_jax`` (both with
the f0 template's ``noise_convs`` where the tree has them),
``vocos_state_dict_from_jax``, ``refinegan_state_dict_from_jax``,
``firefly_state_dict_from_jax`` and ``wavenet_state_dict_from_jax`` are the
inverses of the JAX package's ``from_torch_state_dict`` for those families:
each takes that package's parameter tree (leaves as numpy arrays, or torch
tensors, including ``meta`` ones for a shape-only check) and returns the
state_dict the port's model loads.  ``vae_state_dict_from_jax`` and
``vqvae_state_dict_from_jax`` do the same for the vae and vqvae generators'
trees (an encoder under ``encoder.``, a HiFiGAN under ``decoder.``), and
``vq_state_dict_from_jax`` turns the JAX package's EMA codebook state
(``TrainState.extra["vq"]``) into the quantiser's buffers;
``ssl_state_dict_from_jax`` takes the ssl generator's tree (the post-net, the
decoder) and its EMA state, and ``hubert_state_dict_from_numpy`` a HuBERT
backbone given as numpy arrays under ``transformers``' ``HubertModel`` keys
(the JAX package's frozen extractor holds one).  Layouts:

    conv:            JAX v (K, I, O), g (1, 1, O)  -> original1 (O, I, K), original0 (O, 1, 1)
                     JAX w (K, I/groups, O)        -> weight (O, I/groups, K)   (no weight norm)
    transposed conv: JAX v (K, I, O) time-flipped, g (1, I, 1)
                                                   -> original1 (I, O, K), original0 (I, 1, 1)
    linear:          JAX w (I, O)                  -> weight (O, I)
    layer norm:      JAX scale, bias               -> weight, bias

``load_reference_state_dict`` reads a reference ``.ckpt``/``.pt`` file and
keeps the generator's entries (``generator.`` prefix) under the port's names.

Tensor parallelism: ``shard_state_dict`` cuts a whole state_dict (from any of
the above) into one rank's shard by a model's ``param_specs``
(``parallel/tp_specs.py``), and ``gather_state_dict`` puts the ranks' shards
back together, so that a sharded model loads a one-process checkpoint and its
checkpoints load in one process.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from vocoder_tpu_torch.parallel.tp_specs import key_dims


def _t(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))


def _norm_except_dim0(w: torch.Tensor) -> torch.Tensor:
    return w.flatten(1).norm(dim=1).reshape(-1, *([1] * (w.dim() - 1)))


def _conv(sd: dict, prefix: str, p: dict, transposed: bool = False) -> None:
    def layout(v):
        return v.permute(1, 2, 0).flip(2) if transposed else v.permute(2, 1, 0)

    if "w" in p:  # no weight norm, or folded
        sd[f"{prefix}.weight"] = layout(_t(p["w"])).contiguous()
    else:
        sd[f"{prefix}.parametrizations.weight.original0"] = _t(p["g"]).reshape(-1, 1, 1)
        sd[f"{prefix}.parametrizations.weight.original1"] = layout(_t(p["v"])).contiguous()
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _linear(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["w"]).T.contiguous()
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def _layer_norm(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _snake(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.activation.alpha"] = _t(p["alpha"])
    if "beta" in p:
        sd[f"{prefix}.activation.beta"] = _t(p["beta"])


def _convs12(sd: dict, prefix: str, block: dict) -> None:
    """A resblock's ``convs1.{l}`` and ``convs2.{l}``, keys under ``prefix``."""
    for name in ("convs1", "convs2"):
        for l, conv in enumerate(block[name]):
            _conv(sd, f"{prefix}{name}.{l}", conv)


def amp_block_state_dict_from_jax(block: dict) -> dict[str, torch.Tensor]:
    """One JAX AMP block's parameters -> ``AMPBlock.state_dict()`` layout."""
    sd: dict[str, torch.Tensor] = {}
    _convs12(sd, "", block)
    for a, act in enumerate(block["activations"]):
        _snake(sd, f"activations.{a}", act)
    return sd


def _ups_and_noise_convs(sd: dict, params: dict, prefix: str = "") -> None:
    """conv_pre, the transposed-conv upsamples and, with a template, the plain noise convs."""
    _conv(sd, f"{prefix}conv_pre", params["conv_pre"])
    for i, up in enumerate(params["ups"]):
        _conv(sd, f"{prefix}ups.{i}", up, transposed=True)
    for i, nc in enumerate(params.get("noise_convs", ())):
        _conv(sd, f"{prefix}noise_convs.{i}", nc)


def bigvgan_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX BigVGAN parameter tree -> ``BigVGAN.state_dict()`` layout."""
    sd: dict[str, torch.Tensor] = {}
    _ups_and_noise_convs(sd, params)
    for r, block in enumerate(params["resblocks"]):
        sd.update({f"resblocks.{r}.{k}": v for k, v in amp_block_state_dict_from_jax(block).items()})
    _snake(sd, "activation_post", params["post_act"])
    _conv(sd, "conv_post", params["conv_post"])
    return sd


def hifigan_state_dict_from_jax(params: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """The JAX HiFiGAN parameter tree -> ``HiFiGAN.state_dict()`` layout, keys under ``prefix``."""
    sd: dict[str, torch.Tensor] = {}
    _ups_and_noise_convs(sd, params, prefix)
    for i, stage in enumerate(params["resblocks"]):
        for j, block in enumerate(stage["blocks"]):
            _convs12(sd, f"{prefix}resblocks.{i}.blocks.{j}.", block)
    _conv(sd, f"{prefix}conv_post", params["conv_post"])
    return sd


def refinegan_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX RefineGAN parameter tree -> ``RefineGAN.state_dict()`` layout (each downsample stage's
    ResBlock in slot 1 of its ``Sequential``; AdaIN, ResBlock, AdaIN in slots 0-2 of each upsample block)."""
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, "template_conv", params["template_conv"])
    for i, block in enumerate(params["downsample_blocks"]):
        _convs12(sd, f"downsample_blocks.{i}.1.", block)
    _conv(sd, "mel_conv", params["mel_conv"])
    for i, up in enumerate(params["upsample_conv_blocks"]):
        bp = f"upsample_conv_blocks.{i}"
        _conv(sd, f"{bp}.input_conv", up["input_conv"])
        for j, block in enumerate(up["blocks"]):
            sd[f"{bp}.blocks.{j}.0.weight"] = _t(block["adain1"]["weight"])
            _convs12(sd, f"{bp}.blocks.{j}.1.", block["res"])
            sd[f"{bp}.blocks.{j}.2.weight"] = _t(block["adain2"]["weight"])
    _conv(sd, "output_conv", params["output_conv"])
    return sd


def firefly_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX Firefly parameter tree -> ``Firefly.state_dict()`` layout (``backbone.``, ``head.``)."""
    return {**convnext_state_dict_from_jax(params["backbone"], prefix="backbone."),
            **hifigan_state_dict_from_jax(params["head"], prefix="head.")}


def convnext_state_dict_from_jax(params: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """The JAX ConvNeXt encoder's parameter tree -> ``ConvNeXtEncoder.state_dict()`` layout."""
    sd: dict[str, torch.Tensor] = {}
    for i, down in enumerate(params["downsample"]):
        conv, norm = (0, 1) if i == 0 else (1, 0)
        _conv(sd, f"{prefix}downsample_layers.{i}.{conv}", down["conv"])
        _layer_norm(sd, f"{prefix}downsample_layers.{i}.{norm}", down["norm"])
    for i, stage in enumerate(params["stages"]):
        for j, block in enumerate(stage):
            bp = f"{prefix}stages.{i}.{j}"
            _conv(sd, f"{bp}.dwconv", block["dwconv"])
            _layer_norm(sd, f"{bp}.norm", block["norm"])
            _linear(sd, f"{bp}.pwconv1", block["pwconv1"])
            _linear(sd, f"{bp}.pwconv2", block["pwconv2"])
            if "gamma" in block:
                sd[f"{bp}.gamma"] = _t(block["gamma"])
    _layer_norm(sd, f"{prefix}norm", params["norm"])
    return sd


def vocos_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX Vocos parameter tree -> ``Vocos.state_dict()`` layout."""
    sd = convnext_state_dict_from_jax(params["backbone"], prefix="backbone.")
    _conv(sd, "head.out", params["head"]["out"])
    return sd


def wavenet_state_dict_from_jax(params: dict, prefix: str = "",
                                bn_state: dict | None = None) -> dict[str, torch.Tensor]:
    """The JAX WaveNet posterior encoder's tree -> ``PosteriorEncoder.state_dict()`` layout; a bnvae's
    running statistics come from ``bn_state`` (``wavenet.bn_init``'s tree)."""
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}pre", params["pre"])
    for name in ("in_layers", "res_skip_layers"):
        for i, conv in enumerate(params["enc"][name]):
            _conv(sd, f"{prefix}enc.{name}.{i}", conv)
    _conv(sd, f"{prefix}proj", params["proj"])
    if "mu_bn" in params:
        if bn_state is None:
            raise ValueError("a bnvae encoder's tree needs its bn_state (running mean and var)")
        sd[f"{prefix}mu_bn.bias"] = _t(params["mu_bn"]["bias"])
        sd[f"{prefix}mu_bn.running_mean"] = _t(bn_state["mean"])
        sd[f"{prefix}mu_bn.running_var"] = _t(bn_state["var"])
    return sd


def vq_state_dict_from_jax(vq_state: dict, prefix: str = "vq.") -> dict[str, torch.Tensor]:
    """The JAX EMA VQ state {"layers": [{embed, embed_avg, cluster_size}]} -> the quantiser's buffers."""
    return {f"{prefix}layers.{i}.{k}": _t(layer[k]) for i, layer in enumerate(vq_state["layers"])
            for k in ("embed", "embed_avg", "cluster_size")}


def vae_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX vae generator's tree -> ``VAEGenerator.state_dict()`` layout (a ConvNeXt or WaveNet encoder)."""
    enc = params["encoder"]
    bridge = convnext_state_dict_from_jax if "downsample" in enc else wavenet_state_dict_from_jax
    return {**bridge(enc, prefix="encoder."), **hifigan_state_dict_from_jax(params["decoder"], prefix="decoder.")}


def vqvae_state_dict_from_jax(params: dict, vq_state: dict) -> dict[str, torch.Tensor]:
    """The JAX vqvae generator's tree and its EMA VQ state -> ``VQVAEGenerator.state_dict()`` layout."""
    return {**wavenet_state_dict_from_jax(params["encoder"], prefix="encoder."), **vq_state_dict_from_jax(vq_state),
            **hifigan_state_dict_from_jax(params["decoder"], prefix="decoder.")}


def ssl_state_dict_from_jax(params: dict, vq_state: dict) -> dict[str, torch.Tensor]:
    """The JAX ssl generator's tree {"postnet": {post0, post1, post2}, "decoder"} and its EMA VQ state ->
    ``SSLCodecGenerator.state_dict()`` layout."""
    sd: dict[str, torch.Tensor] = {}
    for name in ("post0", "post1", "post2"):
        _conv(sd, f"postnet.{name}", params["postnet"][name])
    return {**sd, **vq_state_dict_from_jax(vq_state),
            **hifigan_state_dict_from_jax(params["decoder"], prefix="decoder.")}


def hubert_state_dict_from_numpy(sd: dict) -> dict[str, torch.Tensor]:
    """A HuBERT backbone as numpy arrays under ``transformers``' ``HubertModel`` keys (old weight-norm names
    too) -> ``models/hubert.py::HubertModel.state_dict()`` layout: the same keys, so the arrays as tensors."""
    from vocoder_tpu_torch.models.hubert import snapshot_state_dict

    return snapshot_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})


def load_reference_state_dict(path: str | Path, prefix: str = "generator.", keys=None,
                              trust: bool = False) -> dict[str, torch.Tensor]:
    """A reference checkpoint's generator entries, renamed to the port's keys.

    Accepts ``{"state_dict": {...}}`` or a bare state_dict, with weight norm
    as parametrizations, as legacy ``weight_g``/``weight_v``, or folded
    ``weight``.  ``keys``, the state_dict keys of the model that will load the
    result, tells a folded weight-normed ``weight`` (split back into gain and
    direction) from a plain one (kept); without it every ``weight`` is taken
    as weight-normed, as in BigVGAN and HiFiGAN.  The anti-aliasing FIR
    buffers (``*.filter``) and the iSTFT window (``*.window``) are dropped:
    the port computes those.

    Loads tensors and plain containers only (``weights_only``).  A checkpoint
    that also pickles objects (a Lightning ``hyper_parameters`` namespace, say)
    raises ``pickle.UnpicklingError`` naming ``--trust-checkpoint``; with
    ``trust`` it loads with ``weights_only=False``, as the JAX package's CLI
    does, which runs whatever code the pickle holds.
    """
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=not trust)
    except pickle.UnpicklingError as e:
        raise pickle.UnpicklingError(
            f"{path}: the checkpoint pickles objects besides tensors, which loading would run as code; if you "
            f"trust its source, pass --trust-checkpoint (load_reference_state_dict(..., trust=True)) ({e})"
        ) from e
    sd = ckpt.get("state_dict", ckpt)
    keys = None if keys is None else set(keys)
    out: dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        if not key.startswith(prefix) or key.endswith((".filter", ".window")):
            continue
        key = key[len(prefix) :]
        wn = key[: -len("weight")] + "parametrizations.weight.original0"
        if key.endswith(".weight_g"):
            key = key[: -len("weight_g")] + "parametrizations.weight.original0"
        elif key.endswith(".weight_v"):
            key = key[: -len("weight_v")] + "parametrizations.weight.original1"
        elif key.endswith(".weight") and (keys is None or wn in keys):
            out[wn] = _norm_except_dim0(val.float()).to(val.dtype)
            key = key[: -len("weight")] + "parametrizations.weight.original1"
        out[key] = val
    if not out:
        raise ValueError(f"{path}: no {prefix!r} entries")
    return out


def shard_state_dict(sd: dict, specs: dict, rank: int, world: int) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s shard, of ``world`` model ranks, of a whole state_dict: each key that ``specs`` (a
    model's ``param_specs``) shards cut to its rank's contiguous slice, the others as they are."""
    dims = key_dims(specs, sd)
    out = {}
    for key, val in sd.items():
        if key in dims:
            n = val.shape[dims[key]]
            if n % world:
                raise ValueError(f"{key}: {n} channels on dim {dims[key]} do not split over {world} model ranks")
            val = val.narrow(dims[key], rank * (n // world), n // world).contiguous()
        out[key] = val
    return out


def gather_state_dict(shards: list[dict], specs: dict) -> dict[str, torch.Tensor]:
    """The whole state_dict from the ranks' shards, in rank order (``shard_state_dict``'s inverse)."""
    dims = key_dims(specs, shards[0])
    return {key: torch.cat([s[key] for s in shards], dims[key]) if key in dims else val
            for key, val in shards[0].items()}
