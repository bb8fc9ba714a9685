"""Per-request synthesis: one client sends utterances one at a time, each after the last has returned.

A request is what ``cli/infer.py`` does for one file at ``--batch 1``: the host
mel (num_mels, F) to the card, ``cli/infer.py::synthesize`` (unchunked below
``chunk_frames``), the waveform back to the host.  Each request is timed on
the host's clock from its host mel to its host waveform; the window ends with
the request in flight at its deadline.  ``request_p95_ms`` is the 95th
percentile over every request of the window.  The check compares a sample of
the window's first cycle of utterances, drawn from the seed, and the longest
utterance, each against the reference run on it.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import check, program, traffic, weights
from portbench.reference.ops import Precision


def execute(run, device, seconds: float, tracer) -> None:
    spec, cfg = run.traffic, run.cfg
    program.full_precision()
    params = weights.state_dict(run.ref.shapes(cfg["generator"]), lambda k: run.ref.init(cfg["generator"], k),
                                run.seed, "generator", device)
    run.mark("weights")
    model = program.generator(cfg, params, device)
    run.mark("model")
    task = program.task_config(cfg)
    mels, order = traffic.requests(spec, cfg, run.seed, device)
    n = len(mels)
    lengths = [m.shape[1] for m in mels]
    checked = set(weights.rng(run.seed, "check-items").choice(n, spec["check"]["items"], replace=False).tolist())
    if spec["check"].get("longest"):
        checked.add(int(np.argmax(lengths)))
    kept = {}
    run.mark("inputs")

    def request(u: int) -> np.ndarray:
        with record_function("portbench.request"):
            mel = torch.as_tensor(mels[u][None], device=device)
            return program.synthesize(model, mel, task, spec["chunk_frames"])[:, 0, :].float().cpu().numpy()

    with torch.inference_mode():
        for u in range(n):  # warm-up: every utterance length of the mix once
            request(u)
        run.mark("warm-up")
        tracer.start()
        t0 = run.window_started()
        deadline, i, t_end = t0 + seconds, 0, t0
        while t_end < deadline:
            u = order[i]
            t_start = time.perf_counter()
            audio = request(u)
            t_end = time.perf_counter()
            run.request_ms.append(1e3 * (t_end - t_start))
            if i < n and u in checked:
                kept[u] = audio[0].copy()
            if tracer.active:
                run.traced_forwards.append([lengths[u]])
            tracer.poll()
            i += 1
        tracer.stop()
    run.attempted, run.window_s, run.trace = i, t_end - t0, tracer.trace
    run.audio_s = sum(lengths[order[j]] for j in range(i)) * cfg["audio"]["hop_length"] / cfg["audio"]["sampling_rate"]
    if torch.cuda.is_available():
        run.peak_bytes = torch.cuda.max_memory_allocated()
    missing = sorted(checked - set(kept))
    if missing:
        raise RuntimeError(f"the window ended before the first cycle's checked utterances {missing} were served")
    run.kept = {"params": params, "mels": {u: torch.as_tensor(mels[u], device=device) for u in sorted(checked)},
                "outputs": kept}
    del model, mels
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(run, prec: Precision) -> list[np.ndarray]:
    """The reference's waveform of each checked utterance, in ``prec``."""
    out = []
    with torch.no_grad(), prec.active():
        for u in sorted(run.kept["mels"]):
            mel = run.kept["mels"][u][None]
            out.append(run.ref.forward(run.kept["params"], mel, run.cfg["generator"], prec)[0, 0].float().cpu().numpy())
    return out


def compare(run, ref: list, outputs: list | None = None) -> dict:
    """The check's numbers of the program's outputs (or of ``outputs`` in their place) against ``ref``."""
    if outputs is None:
        outputs = [run.kept["outputs"][u] for u in sorted(run.kept["mels"])]
    return check.wave_gap(outputs, ref)
