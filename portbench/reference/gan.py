"""The plain GAN training step: discriminators, losses, AdamW and the schedule.

Published sources: the multi-period discriminator (HiFiGAN, Kong et al. 2020:
per period p the waveform, zero-padded on the right to a multiple of p, viewed
as a (T / p, p) image; (5, 1) convs at stride (3, 1) with SiLU, a (3, 1) post
conv); the multi-resolution discriminator (UnivNet, Jang et al. 2021: per
resolution a magnitude STFT without a window, reflect-padded by
(n_fft - hop) / 2 a side, as a (freq, frames) image; four (3, 9) convs at time
strides 1, 2, 2, 2 and a (3, 3) one, 32 channels, SiLU, a (3, 3) post conv);
LSGAN losses and feature matching, with the scores of the multi-resolution
discriminator concatenated into one (B, D) tensor whose rows are the items
its losses sum over; the multi-resolution STFT loss (Yamamoto et al. 2020:
spectral convergence and log-magnitude L1 over Hann STFTs, centre-padded by
reflection, magnitudes sqrt(max(power, 1e-6))); the mel L1; AdamW (Loshchilov
and Hutter 2019, decoupled weight decay, bias-corrected moments) on a
warmup-cosine learning rate.

The step: the generator's loss
``2.5 * (convergence + log-magnitude) + 45 * mel L1 + mean over {mpd, mrd} of
(adversarial + feature matching)`` on the masked audio, the discriminators on a
crop and with their weights held, the generator's AdamW update; then the
discriminators' loss on the same crop of the real audio and of the detached
fake made before that update, and their AdamW update.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.ops import Precision, log_mel, stft_magnitude, weight, wn_shapes

# The multi-resolution discriminator's convs, (kernel, stride, padding) each, and their channels.
MRD_LAYERS = (((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
              ((3, 3), (1, 1), (1, 1)))
MRD_CHANNELS = (1, 32, 32, 32, 32, 32)


def shapes(train: dict) -> dict[str, tuple]:
    """The discriminators' state dict (``mpd.`` and ``mrd.`` entries) in the reference's names."""
    mpd = train["mpd"]
    chs, k = mpd["channels"], mpd["kernel_size"]
    out = {}
    for i, _ in enumerate(mpd["periods"]):
        name = f"mpd.discriminators.{i}"
        for j in range(len(chs) - 1):
            out.update(wn_shapes(f"{name}.convs.{j}", chs[j + 1], (chs[j + 1], chs[j], k, 1)))
        out.update(wn_shapes(f"{name}.conv_post", 1, (1, chs[-1], 3, 1)))
    for i, _ in enumerate(train["mrd_resolutions"]):
        name = f"mrd.discriminators.{i}"
        for j, (kern, _, _) in enumerate(MRD_LAYERS):
            c_in, c_out = MRD_CHANNELS[j], MRD_CHANNELS[j + 1]
            out.update(wn_shapes(f"{name}.convs.{j}", c_out, (c_out, c_in, *kern)))
        out.update(wn_shapes(f"{name}.conv_post", 1, (1, MRD_CHANNELS[-1], 3, 3)))
    return out


def init(key: str) -> tuple[float, float]:
    """(mean, std) of the normal draw for a discriminator parameter: directions standard normal, gains
    1 within 10% (each layer keeps its input's scale), small biases."""
    if key.endswith("original1"):
        return 0.0, 1.0
    if key.endswith("original0"):
        return 1.0, 0.1
    return 0.0, 0.01


def _disc_p(params, name, x, period, mpd, prec):
    b, c, t = x.shape
    x = F.pad(x, (0, (-t) % period)).reshape(b, c, -1, period)
    fmap = []
    for j in range(len(mpd["channels"]) - 1):
        x = F.silu(prec.conv2d(x, weight(params, f"{name}.convs.{j}"), params[f"{name}.convs.{j}.bias"],
                               stride=(mpd["stride"], 1), padding=(mpd["kernel_size"] // 2, 0)))
        fmap.append(x)
    x = prec.conv2d(x, weight(params, f"{name}.conv_post"), params[f"{name}.conv_post.bias"], padding=(1, 0))
    fmap.append(x)
    return x.flatten(1), fmap


def _disc_r(params, name, audio, res, prec):
    n_fft, hop, win = res
    x = stft_magnitude(audio, n_fft, hop, win, ((n_fft - hop) // 2, (n_fft - hop + 1) // 2), "boxcar",
                       "plain")[:, None]
    fmap = []
    for j, (_, s, p) in enumerate(MRD_LAYERS):
        x = F.silu(prec.conv2d(x, weight(params, f"{name}.convs.{j}"), params[f"{name}.convs.{j}.bias"],
                               stride=s, padding=p))
        fmap.append(x)
    x = prec.conv2d(x, weight(params, f"{name}.conv_post"), params[f"{name}.conv_post.bias"], padding=(1, 1))
    fmap.append(x)
    return x.flatten(1), fmap


def discriminators(params: dict, audio: torch.Tensor, train: dict, prec: Precision) -> dict:
    """audio (B, 1, T) -> {"mpd": (list of (B, D_p) scores, feature maps), "mrd": ((B, sum D) scores,
    feature maps)}."""
    mpd = [_disc_p(params, f"mpd.discriminators.{i}", audio, p, train["mpd"], prec)
           for i, p in enumerate(train["mpd"]["periods"])]
    mrd = [_disc_r(params, f"mrd.discriminators.{i}", audio[:, 0], r, prec)
           for i, r in enumerate(train["mrd_resolutions"])]
    return {"mpd": ([s for s, _ in mpd], [f for _, f in mpd]),
            "mrd": (torch.cat([s for s, _ in mrd], dim=1), [f for _, f in mrd])}


def _item_means(scores, fn):
    """The sum over score items of mean(fn(item)): a list's tensors, or a (B, D) tensor's rows."""
    if isinstance(scores, list):
        return sum(torch.mean(fn(s)) for s in scores)
    return torch.mean(fn(scores), dim=1).sum()


def mr_stft_loss(x: torch.Tensor, y: torch.Tensor, resolutions) -> tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-magnitude L1) of predicted x against y, (B, T) each, averaged over the
    resolutions."""
    sc, mag = 0.0, 0.0
    for n_fft, hop, win in resolutions:
        xm = stft_magnitude(x, n_fft, hop, win, (n_fft // 2, n_fft // 2), "hann", "clamp")
        ym = stft_magnitude(y, n_fft, hop, win, (n_fft // 2, n_fft // 2), "hann", "clamp")
        sc = sc + torch.sqrt(torch.sum((ym - xm) ** 2)) / torch.sqrt(torch.sum(ym ** 2))
        mag = mag + torch.mean(torch.abs(torch.log(ym) - torch.log(xm)))
    return sc / len(resolutions), mag / len(resolutions)


def learning_rate(step: int, sched: dict) -> float:
    """Linear warmup from ``val_start`` to ``val_base``, then a cosine decay to ``val_final``."""
    warm = sched["warm_up_steps"]
    if step < warm:
        return (sched["val_base"] - sched["val_start"]) / max(warm, 1) * step + sched["val_start"]
    t = min((step - warm) / max(sched["max_decay_steps"] - warm, 1), 1.0)
    return sched["val_final"] + 0.5 * (sched["val_base"] - sched["val_final"]) * (1.0 + math.cos(t * math.pi))


class AdamW:
    """AdamW over a dict of leaves, updated in place: decoupled weight decay, then the bias-corrected
    Adam step."""

    def __init__(self, params: dict, adam: dict):
        self.params, self.adam, self.t = params, adam, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict, lr: float) -> None:
        b1, b2, eps, wd = (self.adam[k] for k in ("b1", "b2", "eps", "weight_decay"))
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1 - lr * wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(self.m[k], self.v[k].sqrt() / math.sqrt(c2) + eps, value=-lr / c1)


def generator_loss(gen_forward, pg, pd, audio, lengths, start, cfg: dict, prec: Precision):
    """(loss, crop of the masked audio, crop of the masked fake) of the generator phase."""
    train, audio_cfg = cfg["train"], cfg["audio"]
    t = audio.shape[-1]
    mask = (torch.arange(t, device=audio.device)[None, :] < lengths[:, None]).float()[:, None, :]
    fake = gen_forward(pg, log_mel(audio[:, 0], audio_cfg), cfg["generator"], prec, remat=True)
    audio_m, fake_m = audio * mask, fake * mask
    sc, mag = mr_stft_loss(fake_m[:, 0], audio_m[:, 0], train["mrd_resolutions"])
    mel = torch.mean(torch.abs(log_mel(audio_m[:, 0], audio_cfg) - log_mel(fake_m[:, 0], audio_cfg)))
    crop = train["crop_length"]
    audio_c, fake_c = audio_m[..., start:start + crop], fake_m[..., start:start + crop]
    held = {k: v.detach() for k, v in pd.items()}
    fake_out = discriminators(held, fake_c, train, prec)
    with torch.no_grad():
        real_out = discriminators(held, audio_c, train, prec)
    adv = 0.0
    for key, (scores, fmaps) in fake_out.items():
        fm = sum(torch.mean(torch.abs(r - f)) for rs, fs in zip(real_out[key][1], fmaps) for r, f in zip(rs, fs))
        adv = adv + _item_means(scores, lambda s: (1.0 - s) ** 2) + fm
    adv = adv / len(fake_out)
    loss = (sc + mag) * train["stft_weight"] + mel * train["mel_weight"] + adv
    return loss, audio_c, fake_c


def discriminator_loss(pd, audio_c, fake_c, train: dict, prec: Precision) -> torch.Tensor:
    real = discriminators(pd, audio_c, train, prec)
    fake = discriminators(pd, fake_c.detach(), train, prec)
    total = sum(_item_means(real[k][0], lambda s: (s - 1.0) ** 2) + _item_means(fake[k][0], lambda s: s ** 2)
                for k in real)
    return total / len(real)


def train_steps(gen_forward, params_g: dict, params_d: dict, batches, cfg: dict, prec: Precision) -> dict:
    """Run the steps of ``batches`` (a list of (audio (B, 1, T), lengths (B,), crop start)) from the given
    weights, which stay as they are.  Returns {"losses": [(generator loss, discriminator loss)] a step,
    "first_grads": {leaf: norm of its gradient in the first step}, "params": {leaf: its value after the
    last step}}."""
    train = cfg["train"]
    pg = {k: v.detach().clone().requires_grad_(True) for k, v in params_g.items()}
    pd = {k: v.detach().clone().requires_grad_(True) for k, v in params_d.items()}
    opt_g, opt_d = AdamW(pg, train["adam"]), AdamW(pd, train["adam"])
    losses, first = [], {}
    with prec.active():
        for step, (audio, lengths, start) in enumerate(batches):
            lr = learning_rate(step, train["schedule"])
            loss_g, audio_c, fake_c = generator_loss(gen_forward, pg, pd, audio, lengths, start, cfg, prec)
            grads = dict(zip(pg, torch.autograd.grad(loss_g, list(pg.values()))))
            fake_c = fake_c.detach()
            opt_g.step(grads, lr)
            loss_d = discriminator_loss(pd, audio_c.detach(), fake_c, train, prec)
            grads_d = dict(zip(pd, torch.autograd.grad(loss_d, list(pd.values()))))
            opt_d.step(grads_d, lr)
            if step == 0:
                first = {k: float(torch.linalg.vector_norm(g)) for k, g in {**grads, **grads_d}.items()}
            losses.append((float(loss_g.detach()), float(loss_d.detach())))
            del grads, grads_d, loss_g, loss_d, audio_c, fake_c
    return {"losses": losses, "first_grads": first, "params": {k: v.detach() for k, v in {**pg, **pd}.items()}}
