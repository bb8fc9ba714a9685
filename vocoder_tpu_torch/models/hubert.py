"""HuBERT (the base architecture) as a plain ``torch.nn.Module``, for the ssl family's frozen backbone.

The JAX package runs ``transformers``' ``HubertModel`` on the host
(``vocoder_tpu/models/ssl_encoders.py``); the card's machine has no
``transformers``, so the port carries the model itself.  ``HubertModel``
computes what that class computes under ``HubertConfig``'s defaults, in eval
mode, with no masking and no attention mask (how the extractor calls it):

- the feature encoder: 7 convs without bias, kernels (10, 3, 3, 3, 3, 2, 2),
  strides (5, 2, 2, 2, 2, 2, 2), one frame per 320 samples; a GroupNorm with
  one group a channel (affine, eps 1e-5) after the first conv only
  (``feat_extract_norm="group"``); exact GELU after each;
- the feature projection: LayerNorm(512) then Linear(512 -> hidden);
- the encoder: the positional conv (grouped, kernel 128, 16 groups, padding
  64, weight norm over every dimension but the kernel's, ``dim=2``; its last
  frame dropped, the kernel being even; exact GELU) added to its input, a
  LayerNorm, then the post-LN layers (``do_stable_layer_norm=False``): x =
  LN(x + attention(x)); x = LN(x + FFN(x)), the FFN Linear -> GELU -> Linear.

Submodule names are ``transformers``', so ``HubertModel.state_dict()`` of that
package loads here as it is (``masked_spec_embed`` included, which eval never
reads, and the positional conv's ``parametrizations.weight.original0/1``).
``load_snapshot`` reads a local ``save_pretrained`` directory without that
package: ``config.json``, and ``model.safetensors`` (a small numpy reader of
its header and buffer) or ``pytorch_model.bin``; the old weight-norm names
``weight_g`` / ``weight_v`` and a ``hubert.`` prefix are mapped as
``from_pretrained`` maps them.  A snapshot of another architecture (layer-norm
feature encoder, pre-LN "stable" layers, ...) is refused by name.

``random_state_dict`` draws weights from a ``torch.Generator`` in the
distributions of ``HubertPreTrainedModel._init_weights``: linear weights
normal(0, 0.02) and zero biases, norms at 1 and 0, the feature convs
Kaiming-normal (std sqrt(2 / fan_in)), the positional conv PyTorch's default
uniform(+-1/sqrt(fan_in)) direction with its norm as gain (``_init_weights``
cannot reach a weight-normed weight) and a zero bias, ``masked_spec_embed``
uniform(0, 1).  The attention is ``F.scaled_dot_product_attention``: the JAX
package computes it in ``transformers``' torch code, not in a Pallas kernel,
so the port owes no kernel for it.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.parametrizations import weight_norm


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    """The fields of ``transformers.HubertConfig`` that size the base architecture, at its defaults."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: tuple = (512,) * 7
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02

    # config.json values of the architecture this module computes; any other is refused.
    ARCHITECTURE = {"feat_extract_norm": "group", "do_stable_layer_norm": False, "feat_proj_layer_norm": True,
                    "conv_pos_batch_norm": False, "hidden_act": "gelu", "feat_extract_activation": "gelu"}

    @classmethod
    def from_json(cls, d: dict) -> "HubertConfig":
        """A snapshot's ``config.json`` (``transformers``' keys; absent ones take the defaults)."""
        for key, want in cls.ARCHITECTURE.items():
            if d.get(key, want) != want:
                raise ValueError(f"HuBERT config {key}={d[key]!r}: the port computes only {key}={want!r}")
        kw = {f.name: tuple(d[f.name]) if isinstance(d[f.name], list) else d[f.name]
              for f in dataclasses.fields(cls) if f.name in d}
        return cls(**kw)


class _ConvLayer(nn.Module):
    """conv -> [GroupNorm, one group a channel] -> GELU."""

    def __init__(self, cfg: HubertConfig, i: int, device=None):
        super().__init__()
        c_in = cfg.conv_dim[i - 1] if i > 0 else 1
        c = cfg.conv_dim[i]
        self.conv = nn.Conv1d(c_in, c, cfg.conv_kernel[i], stride=cfg.conv_stride[i], bias=cfg.conv_bias,
                              device=device)
        if i == 0:
            self.layer_norm = nn.GroupNorm(c, c, affine=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if hasattr(self, "layer_norm"):
            x = self.layer_norm(x)
        return F.gelu(x)


class _FeatureEncoder(nn.Module):
    def __init__(self, cfg: HubertConfig, device=None):
        super().__init__()
        self.conv_layers = nn.ModuleList([_ConvLayer(cfg, i, device) for i in range(len(cfg.conv_dim))])

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = audio[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig, device=None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps, device=device)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class _PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: HubertConfig, device=None):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                         groups=cfg.num_conv_pos_embedding_groups, device=device)
        self.conv = weight_norm(conv, name="weight", dim=2)
        self.drop_last = k % 2 == 0  # HubertSamePadLayer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, H) -> (B, T, H)."""
        y = self.conv(x.transpose(1, 2))
        if self.drop_last:
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, cfg: HubertConfig, device=None):
        super().__init__()
        h = cfg.hidden_size
        if h % cfg.num_attention_heads:
            raise ValueError(f"hidden_size {h} is not a multiple of num_attention_heads {cfg.num_attention_heads}")
        self.heads = cfg.num_attention_heads
        self.k_proj = nn.Linear(h, h, device=device)
        self.v_proj = nn.Linear(h, h, device=device)
        self.q_proj = nn.Linear(h, h, device=device)
        self.out_proj = nn.Linear(h, h, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape

        def heads(y):
            return y.view(b, t, self.heads, h // self.heads).transpose(1, 2)

        out = F.scaled_dot_product_attention(heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, t, h))


class _FeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig, device=None):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _EncoderLayer(nn.Module):
    """Post-LN: x = LN(x + attention(x)); x = LN(x + FFN(x))."""

    def __init__(self, cfg: HubertConfig, device=None):
        super().__init__()
        self.attention = _Attention(cfg, device)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.feed_forward = _FeedForward(cfg, device)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig, device=None):
        super().__init__()
        self.pos_conv_embed = _PositionalConvEmbedding(cfg, device)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.layers = nn.ModuleList([_EncoderLayer(cfg, device) for _ in range(cfg.num_hidden_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x)
        return x


class HubertModel(nn.Module):
    """audio (B, T) -> last_hidden_state (B, T', hidden), T' = the feature encoder's frames (T // 320 - 1
    for T a multiple of 320 at the default strides)."""

    def __init__(self, cfg: HubertConfig = HubertConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureEncoder(cfg, device)
        self.feature_projection = _FeatureProjection(cfg, device)
        self.masked_spec_embed = nn.Parameter(torch.empty(cfg.hidden_size, device=device))  # masking only
        self.encoder = _Encoder(cfg, device)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = self.feature_extractor(audio).transpose(1, 2)
        return self.encoder(self.feature_projection(x))


def from_state_dict(cfg: HubertConfig, sd: dict[str, torch.Tensor]) -> HubertModel:
    """``HubertModel(cfg)`` on the CPU holding ``sd`` (strict keys), built without drawing a default init."""
    model = HubertModel(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(sd)
    return model


def random_state_dict(cfg: HubertConfig, seed: int) -> dict[str, torch.Tensor]:
    """fp32 CPU weights for ``HubertModel(cfg)`` drawn from ``torch.Generator().manual_seed(seed)`` in the
    distributions of ``HubertPreTrainedModel._init_weights`` (the module docstring lists them)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    shapes = {k: tuple(v.shape) for k, v in HubertModel(cfg, device="meta").state_dict().items()}
    for key, shape in shapes.items():
        w = torch.empty(shape)
        if key == "masked_spec_embed":
            w.uniform_(0.0, 1.0, generator=gen)
        elif key.startswith("feature_extractor.") and key.endswith("conv.weight"):
            w.normal_(0.0, (2.0 / (shape[1] * shape[2])) ** 0.5, generator=gen)  # Kaiming normal, fan in
        elif key.endswith("original1"):  # the positional conv's direction: PyTorch's default conv init
            bound = 1.0 / (shape[1] * shape[2]) ** 0.5
            w.uniform_(-bound, bound, generator=gen)
        elif key.endswith("original0"):
            continue  # its direction's norm, below
        elif "layer_norm" in key:
            w.fill_(1.0 if key.endswith("weight") else 0.0)
        elif key.endswith("weight"):  # linear
            w.normal_(0.0, cfg.initializer_range, generator=gen)
        else:  # every bias
            w.zero_()
        sd[key] = w
    v = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"]
    sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"] = torch.linalg.vector_norm(
        v, dim=(0, 1), keepdim=True)
    return {k: sd[k] for k in shapes}


_SAFETENSORS_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
                       "I64": np.int64, "I32": np.int32}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU: an 8-byte little-endian header length, a JSON
    header {name: {dtype, shape, data_offsets}}, then the buffer the offsets index."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = np.frombuffer(f.read(), np.uint8)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {meta['dtype']}, which this reader does not know")
        lo, hi = meta["data_offsets"]
        arr = buf[lo:hi].view(_SAFETENSORS_DTYPES[meta["dtype"]]).reshape(meta["shape"])
        t = torch.from_numpy(arr.copy())
        out[name] = t.view(torch.bfloat16) if meta["dtype"] == "BF16" else t
    return out


def snapshot_state_dict(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A snapshot's tensors under this module's keys: a ``hubert.`` prefix stripped and the old weight-norm
    names ``weight_g`` / ``weight_v`` mapped to ``parametrizations.weight.original0/1``."""
    out = {}
    for key, val in sd.items():
        key = key.removeprefix("hubert.")
        if key.endswith(".weight_g"):
            key = key[: -len("weight_g")] + "parametrizations.weight.original0"
        elif key.endswith(".weight_v"):
            key = key[: -len("weight_v")] + "parametrizations.weight.original1"
        out[key] = val
    return out


def load_snapshot(directory: str | Path) -> HubertModel:
    """The HuBERT of a local ``save_pretrained`` directory (``config.json`` and ``model.safetensors`` or
    ``pytorch_model.bin``), fp32 on the CPU.  Tensors the model does not have (a pretraining head's) are
    dropped; a missing one raises, but ``masked_spec_embed``, which eval never reads."""
    directory = Path(directory)
    cfg = HubertConfig.from_json(json.loads((directory / "config.json").read_text()))
    if (directory / "model.safetensors").is_file():
        raw = read_safetensors(directory / "model.safetensors")
    elif (directory / "pytorch_model.bin").is_file():
        raw = torch.load(directory / "pytorch_model.bin", map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{directory}: neither model.safetensors nor pytorch_model.bin")
    sd = snapshot_state_dict(raw)
    want = HubertModel(cfg, device="meta").state_dict()
    missing = [k for k in want if k not in sd and k != "masked_spec_embed"]
    if missing:
        raise ValueError(f"{directory}: the snapshot lacks {len(missing)} HuBERT tensors, e.g. {missing[:3]}")
    sd.setdefault("masked_spec_embed", torch.zeros(cfg.hidden_size))
    return from_state_dict(cfg, {k: sd[k].float() for k in want})
