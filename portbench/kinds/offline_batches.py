"""Offline synthesis: jobs of utterances, batched as ``cli/infer.py::batched_synthesis`` batches them.

A job's items are sorted by length and taken ``batch`` at a time; each group
is padded with zeros to its longest item, runs one forward with
``frame_lengths``, and comes back to the host, where each row is cut to its
item's samples.  Jobs follow one another until the window's time is up; the
group in flight then completes and counts.  ``synth_audio_s_per_s`` is the
audio returned over the time from the window's start to the last group's
return.  The check compares a sample of the first job's items, drawn from the
seed, and its longest item, each against the reference run on that item alone.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check, program, traffic, weights
from portbench.reference.ops import Precision


def groups(job: list, batch: int) -> list[list[int]]:
    """Item indices of each group: the job's items sorted by frame count, ``batch`` at a time."""
    order = sorted(range(len(job)), key=lambda i: job[i].shape[1])
    return [order[g:g + batch] for g in range(0, len(order), batch)]


def sample(run, lengths: list[int]) -> list[int]:
    """The items that the check compares: ``check.items`` drawn from the seed, and the longest."""
    spec = run.traffic["check"]
    picked = set(weights.rng(run.seed, "check-items").choice(len(lengths), spec["items"], replace=False).tolist())
    if spec.get("longest"):
        picked.add(int(np.argmax(lengths)))
    return sorted(picked)


def execute(run, device, seconds: float, tracer) -> None:
    spec, cfg = run.traffic, run.cfg
    hop, sr, num_mels = cfg["audio"]["hop_length"], cfg["audio"]["sampling_rate"], cfg["audio"]["num_mels"]
    program.full_precision()
    params = weights.state_dict(run.ref.shapes(cfg["generator"]), lambda k: run.ref.init(cfg["generator"], k),
                                run.seed, "generator", device)
    run.mark("weights")
    model = program.generator(cfg, params, device)
    run.mark("model")
    task = program.task_config(cfg)
    jobs = traffic.offline_jobs(spec, cfg, run.seed, device)
    lo = program.min_batch_frames(task)
    for job in jobs:
        bad = [m.shape[1] for m in job if m.shape[1] > spec["chunk_frames"] or m.shape[1] < lo]
        if bad:
            raise ValueError(f"items of {bad} frames would leave the batched path "
                             f"(the CLI batches {lo}..{spec['chunk_frames']} frames)")
    plan = [groups(job, spec["batch"]) for job in jobs]
    run.mark("inputs")
    checked = sample(run, [m.shape[1] for m in jobs[0]])
    kept = {}

    def synth(job, group, keep):
        frames = [job[i].shape[1] for i in group]
        with record_function("portbench.pad"):
            mel_b = torch.zeros(len(group), num_mels, max(frames), device=device)
            for j, i in enumerate(group):
                mel_b[j, :, : frames[j]] = job[i]
            lens = torch.tensor(frames, dtype=torch.int32, device=device)
        with record_function("portbench.forward"):
            out = model(mel_b, frame_lengths=lens)
        with record_function("portbench.d2h"):
            audio = out[:, 0].float().cpu().numpy()
        for j, i in enumerate(group):
            if keep and i in checked:
                kept[i] = audio[j, : frames[j] * hop].copy()
        return frames

    with torch.inference_mode():
        for g in plan[0]:  # warm-up: every group shape of the mix (every job has the same lengths)
            synth(jobs[0], g, keep=False)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        run.mark("warm-up")
        tracer.start()
        t0 = run.window_started()
        deadline, done, n_job, t_last = t0 + seconds, False, 0, t0
        audio_s = 0.0
        while not done:
            job, first = jobs[n_job % len(jobs)], n_job == 0
            for g in plan[n_job % len(jobs)]:
                traced = tracer.active
                frames = synth(job, g, keep=first)
                t_last = time.perf_counter()
                audio_s += sum(frames) * hop / sr
                run.attempted += len(frames)
                if traced:
                    run.traced_forwards.append(frames)
                tracer.poll()
                if t_last >= deadline:
                    done = True
                    break
            n_job += 1
        tracer.stop()
    run.window_s, run.audio_s, run.trace = t_last - t0, audio_s, tracer.trace
    if torch.cuda.is_available():
        run.peak_bytes = torch.cuda.max_memory_allocated()
    missing = [i for i in checked if i not in kept]
    if missing:
        raise RuntimeError(f"the window ended before the first job's checked items {missing} were synthesised")
    run.kept = {"params": params, "mels": {i: jobs[0][i].clone() for i in checked}, "outputs": kept}
    del model, jobs, plan
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(run, prec: Precision) -> list[np.ndarray]:
    """The reference's waveform of each checked item, alone at its own length, in ``prec``."""
    ref = run.ref
    params, cfg = run.kept["params"], run.cfg
    out = []
    with torch.no_grad(), prec.active():
        for i in sorted(run.kept["mels"]):
            mel = run.kept["mels"][i]
            out.append(ref.forward(params, mel[None], cfg["generator"], prec)[0, 0].float().cpu().numpy())
    return out


def compare(run, ref: list, outputs: list | None = None) -> dict:
    """The check's numbers of the program's outputs (or of ``outputs`` in their place) against ``ref``."""
    if outputs is None:
        outputs = [run.kept["outputs"][i] for i in sorted(run.kept["mels"])]
    return check.wave_gap(outputs, ref)
