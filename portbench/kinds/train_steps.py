"""Training: back-to-back GAN steps, each the generator phase then the discriminator phase.

Set-up builds one training state (``train/gan.py::create_train_state``) holding
the benchmark's weights and drives it from the seed through its first
``check_steps`` steps, through the same calls and feed as the window: the
step's ``g_phase`` and ``d_phase`` on the mix's pool of batches, with the crop
starts drawn from the seed.  It keeps each of those steps' losses, the norm
of each leaf's first gradient as AdamW got it (its first moment after one
step over 1 - beta1) and each leaf's change over those steps.  The window
then goes on with the same state, step after step, until its time is up; the
step in flight completes, and a ``synchronize`` ends the window.
``train_audio_s_per_s`` is the steps' audio over the window's time.  The
traced run also times each phase with CUDA events.  The check runs the
reference's steps from the same weights on the same batches and crops.
"""

from __future__ import annotations

import gc
import time

import torch
from torch.profiler import record_function

from portbench import check, program, traffic, weights
from portbench.reference import gan as ref_gan
from portbench.reference.ops import Precision


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def _batch(run, step: int) -> tuple:
    b = run.kept["batches"][step % len(run.kept["batches"])]
    return b, run.kept["starts"][step]


def execute(run, device, seconds: float, tracer) -> None:
    spec, cfg = run.traffic, run.cfg
    program.full_precision()
    params_g = weights.state_dict(run.ref.shapes(cfg["generator"]), lambda k: run.ref.init(cfg["generator"], k),
                                  run.seed, "generator", device)
    params_d = weights.state_dict(ref_gan.shapes(cfg["train"]), ref_gan.init, run.seed, "discriminators", device)
    run.mark("weights")
    task, state, step = program.train_state(cfg, params_g, params_d, run.seed, device)
    run.mark("model")
    run.kept = {"params": {**params_g, **params_d}, "modules": {"generator": list(params_g),
                                                                "discriminators": list(params_d)},
                "batches": traffic.train_batches(spec, cfg, run.seed, device),
                "starts": traffic.crop_starts(spec, cfg, run.seed, spec["max_steps"])}
    run.mark("inputs")
    b1 = cfg["train"]["adam"]["b1"]
    named = {**{k: p for k, p in state.generator.named_parameters()},
             **{k: p for k, p in state.discriminators.named_parameters()}}
    opts = [state.opt_g, state.opt_d]
    losses, first = [], {}
    for s in range(spec["check_steps"]):
        batch, start = _batch(run, s)
        metrics, audio_c, fake_c = step.g_phase(state, batch, start)
        metrics.update(step.d_phase(state, audio_c, fake_c))
        losses.append(tuple(float(metrics[f"train/{m}/all"].detach()) for m in ("generator", "discriminator")))
        if s == 0:
            moments = {k: o.state[p]["exp_avg"] for o in opts for k, p in named.items() if "exp_avg" in o.state[p]}
            first = {k: 0.0 for k in named} | {k: v / (1 - b1) for k, v in _norms(moments).items()}
    changes = _norms({k: p.detach() - run.kept["params"][k] for k, p in named.items()})
    run.kept["program"] = {"losses": losses, "first_grads": first, "changes": changes}
    run.mark("checked steps")

    events = []
    tracer.start()
    t0 = run.window_started()
    deadline, k = t0 + seconds, spec["check_steps"]
    if torch.cuda.is_available():
        run.peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    while True:
        batch, start = _batch(run, k)
        ev = None
        if tracer.on and torch.cuda.is_available():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        traced = tracer.active
        if ev:
            ev[0].record()
        with record_function("portbench.g_phase"):
            _, audio_c, fake_c = step.g_phase(state, batch, start)
        if ev:
            ev[1].record()
        with record_function("portbench.d_phase"):
            step.d_phase(state, audio_c, fake_c)
        if ev:
            ev[2].record()
            events.append(ev)
        k += 1
        run.traced_steps += traced
        tracer.poll()
        if time.perf_counter() >= deadline:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    tracer.stop()
    steps = k - spec["check_steps"]
    samples = spec["batch"] * spec["frames"] * cfg["audio"]["hop_length"]
    run.attempted, run.window_s, run.trace = steps, t_end - t0, tracer.trace
    run.audio_s = steps * samples / cfg["audio"]["sampling_rate"]
    run.g_phase_ms = [a.elapsed_time(b) for a, b, _ in events]
    run.d_phase_ms = [b.elapsed_time(c) for _, b, c in events]
    if torch.cuda.is_available():
        run.window_peak_bytes = torch.cuda.max_memory_allocated()
        run.peak_bytes = max(run.peak_bytes, run.window_peak_bytes)
    del state, step, task, named, opts, audio_c, fake_c
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(run, prec: Precision, rows: slice = slice(None)) -> dict:
    """The reference's checked steps from the same weights, batches and crops, in ``prec``; ``rows``: the
    batch rows it takes (all of them, or a fault's part)."""
    cfg, params = run.cfg, run.kept["params"]
    pg = {k: params[k] for k in run.kept["modules"]["generator"]}
    pd = {k: params[k] for k in run.kept["modules"]["discriminators"]}
    batches = []
    for s in range(run.traffic["check_steps"]):
        b, start = _batch(run, s)
        batches.append((b["audio"][rows], b["lengths"][rows], start))
    out = ref_gan.train_steps(run.ref.forward, pg, pd, batches, cfg, prec)
    changes = _norms({k: v - params[k] for k, v in out.pop("params").items()})
    return {**out, "changes": changes}


def compare(run, ref: dict, outputs: dict | None = None) -> dict:
    """The check's numbers of the program's steps (or of ``outputs`` in their place) against ``ref``."""
    return check.train_gaps(run.kept["program"] if outputs is None else outputs, ref, run.kept["modules"])
