"""The training loop.

Counterpart of ``vocoder_tpu/train/trainer.py`` on one device: ``config.json``
and the guard against resuming a workdir that holds another task's
checkpoint, auto-resume from the latest checkpoint (or a weights-only start
from ``run.ckpt_path``), the first step, then the loop with its log window
(``perf/steps_per_s``, ``perf/audio_s_per_s``, ``perf/input_wait_s``, which
holds the host's f0 templates where the generator consumes them), the
validation every ``run.val_interval`` steps (the mel-L1, with
``run.early_stop_patience``; PESQ-WB on the host with ``run.val_pesq``, the
default; GT-vs-generated audio and mel figures of the first clip in
``<workdir>/media`` and TensorBoard), a checkpoint every ``run.ckpt_interval``
steps and a forced one at the end, and ``crash.log`` when a step raises.
Each validation also records its seconds in the eval forwards
(``perf/val_forward_s``, CUDA events on the card) and in host PESQ
(``perf/val_pesq_s``).

Every training batch, the first included, comes through
``data.dataset.DevicePrefetcher``: a thread makes the host batches two ahead
and copies them to the card from pinned memory on a side stream, and
``perf/input_wait_s`` is the time the loop blocked on it in the log window.
``run.profile_steps=(start, stop)`` traces steps [start, stop) with
``torch.profiler`` (CPU and, on the card, CUDA activities) into a Chrome
trace under ``<workdir>/profile/``, whose path the log names; the trace's
kernel names are what a reading of the step's card time starts from.
Under ``task.compute_dtype="bfloat16"`` validation runs a bf16 copy of the
generator (``train/gan.py::eval_generator``), BigVGAN's stages on K2's bf16
route.

Every family that ``train/gan.py`` trains runs through it unchanged: the
step makes the family's input (log-mel or linear spectrogram), validation
runs the family's eval forward, and a vqvae's or ssl's EMA codebooks, buffers
of the generator, are saved and restored with its ``state_dict``.  The ssl
family's frozen HuBERT (``models/ssl_encoders.py::HubertFeatureExtractor``,
on the training device) makes each batch's features on the card, right after
the batch arrives, and each validation batch's once, when the validation
batches are built (the JAX package makes them in its data thread on the
host; where they are made changes time, not numbers); the log window's
``perf/ssl_features_s`` is the time between CUDA events around those calls
(the card's time on them, with any gap in which it waited for the host).

``run.precision="highest"`` (the default) runs the library's convs and
matmuls in full fp32 (TF32 off), as the JAX package's ``Precision.HIGHEST``;
"default" lets them use TF32, as its ``Precision.DEFAULT`` lets the MXU round.

Data parallelism (``torchrun --nproc_per_node N -m vocoder_tpu_torch.cli.train
...``; ``parallel/dist.py``): ``train`` joins the process group of torchrun's
environment first (``cuda`` is then ``cuda:LOCAL_RANK``, NCCL; gloo on the
CPU), refuses a layout that the processes cannot run (``check_parallel``) and
lays them out as the JAX package's ("data", "model") mesh (``parallel/tp.py::
make_grid``): ``run.model_parallel`` consecutive ranks form a model group that
holds one generator in shards (tensor parallelism, ``train/gan.py``) and stores
the discriminators, and a generator without explicit specs, in slices (the JAX
package's per-leaf storage sharding), and the ranks that hold the same shard
form the data group.  Each model group reads
one share of the batch from ``batch_iterator(host_index=data rank)``
(``data.batch_size // data-parallel ranks`` items, as the JAX package's hosts)
into each of its cards.  Every rank builds the state from the seed or restores
the same checkpoint; the first rank of each data group broadcasts its shards
over it (rank 0 the discriminators over all ranks where they are whole); the
step is the global batch's (``train/gan.py``).  Rank 0 alone writes
``config.json``, ``metrics.jsonl``, media, TensorBoard, checkpoints (whole
tensors, gathered over its model group), ``crash.log`` and the profiler trace;
rank 0's model group runs the validation's forwards (the eval forwards over
every validation batch, so its figures are one process's) and rank 0 its PESQ,
while the other ranks wait for its early-stop decision.  The logged losses and
grad norms are the global batch's and ``perf/audio_s_per_s`` counts the global
batch.  The run's log ends with the hand kernels' launches in this process
(``ops.launch_counts``).

Not ported (ROADMAP.md): W&B (the card's machine has neither ``wandb`` nor a
network; ``metrics.jsonl``, the media PNGs and TensorBoard stand in).
"""

from __future__ import annotations

import dataclasses
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from vocoder_tpu_torch.config import TrainConfig
from vocoder_tpu_torch.data import transforms as T
from vocoder_tpu_torch.data.dataset import DevicePrefetcher, MixDataset, VocoderDataset, batch_iterator
from vocoder_tpu_torch.data.f0 import f0_template
from vocoder_tpu_torch.data.resample import resample
from vocoder_tpu_torch.eval_metrics import pesq as pesq_metric
from vocoder_tpu_torch.models.ssl_encoders import HubertFeatureExtractor
from vocoder_tpu_torch.nn import set_full_precision
from vocoder_tpu_torch.ops import launch_counts
from vocoder_tpu_torch.parallel import dist, tp
from vocoder_tpu_torch.train import gan
from vocoder_tpu_torch.utils.checkpoint import CheckpointManager
from vocoder_tpu_torch.utils.logging import MetricsLogger, log
from vocoder_tpu_torch.utils.viz import plot_mel


def set_precision(precision: str) -> None:
    if precision == "highest":
        set_full_precision()
    elif precision == "default":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    else:
        raise ValueError(f"unknown run.precision {precision!r}; 'highest' or 'default'")


def _build_train_sampler(cfg: TrainConfig):
    task = cfg.task
    tr = T.train_transform(task.sampling_rate, task.hop_length, task.num_frames)
    roots = list(cfg.data.train_roots)
    if not roots:
        raise ValueError("data.train_roots must be set")
    probs = list(cfg.data.train_probs) or [1.0] * len(roots)
    return MixDataset(datasets=[VocoderDataset(root=r, transform=tr) for r in roots], probs=probs).sample


def template_fn(task):
    """For a generator that consumes an f0 template: audio (T,) -> its template (T,), on the host; else None."""
    if not gan.needs_template(task):
        return None
    return lambda audio: f0_template(audio, task.sampling_rate, task.hop_length)


def _build_val_batches(cfg: TrainConfig, extractor: HubertFeatureExtractor | None = None) -> list[dict] | None:
    """Fixed validation batches: each clip's first channel cut or zero-padded to val_crop_frames hops,
    with each clip's f0 template (of the padded clip) where the generator consumes one, and the ssl
    family's features of the padded batch (``extractor``'s, made on its device, kept on the host)."""
    if cfg.data.val_root is None:
        return None
    task = cfg.task
    ds = VocoderDataset(root=cfg.data.val_root,
                        transform=T.val_transform(task.sampling_rate, task.hop_length, cfg.data.val_crop_frames))
    target = task.hop_length * cfg.data.val_crop_frames
    rng = np.random.default_rng(cfg.run.seed)
    b = cfg.data.val_batch_size
    tfn = template_fn(task)
    batches = []
    for i in range(0, len(ds), b):
        audios, lengths = [], []
        for j in range(i, min(i + b, len(ds))):
            a = ds.get(rng, j)[:1]
            n = min(a.shape[-1], target)
            audios.append(np.pad(a[..., :n], ((0, 0), (0, target - n))))
            lengths.append(n)
        while len(audios) < b:  # a fixed batch shape, as the JAX package keeps
            audios.append(np.zeros_like(audios[0]))
            lengths.append(0)
        batch = {"audio": np.stack(audios).astype(np.float32), "lengths": np.asarray(lengths, np.int64)}
        if tfn is not None:
            batch["template"] = np.stack([tfn(a[0]) for a in audios])[:, None, :].astype(np.float32)
        if extractor is not None:
            batch["ssl_features"] = extractor(torch.from_numpy(batch["audio"][:, 0])).cpu().numpy()
        batches.append(batch)
    return batches


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items()}


def _check_config(cfg: TrainConfig, workdir: Path, ckpt: CheckpointManager) -> None:
    """Refuse a workdir whose checkpoint was trained with another task config (the keys its config.json
    records, so fields added since do not block a resume)."""
    task_now = json.loads(json.dumps(dataclasses.asdict(cfg.task), default=str))
    cfg_path = workdir / "config.json"
    if cfg_path.exists() and ckpt.latest_step() is not None:
        task_prev = json.loads(cfg_path.read_text()).get("task") or {}
        diff = [k for k in sorted(task_prev) if k in task_now and task_prev[k] != task_now[k]]
        if diff:
            raise SystemExit(
                f"workdir {workdir} holds a checkpoint (step {ckpt.latest_step()}) trained with a different "
                f"task config (differs in: {', '.join(diff)}). Point run.workdir at a fresh directory, or pass "
                "the old model/resolution flags to resume it.")


def check_parallel(cfg: TrainConfig, world: int) -> None:
    """Refuse, by the field's name, a layout that ``world`` processes cannot run: a ``run.model_parallel``
    that does not divide them, a ``run.data_parallel`` other than world // run.model_parallel, a batch or
    validation batch that the data-parallel ranks cannot share equally (the JAX trainer's checks)."""
    run, data = cfg.run, cfg.data
    mp = run.model_parallel
    if mp < 1 or world % mp:
        raise SystemExit(f"run.model_parallel={mp} does not divide the number of processes ({world}); launch a "
                         "multiple of it with torchrun --nproc_per_node")
    dp = world // mp
    if run.data_parallel is not None and run.data_parallel != dp:
        raise SystemExit(f"run.data_parallel={run.data_parallel} must be the number of processes ({world}) // "
                         f"run.model_parallel ({mp}), or None")
    of = "" if mp == 1 else f" of data parallelism ({world} // run.model_parallel={mp})"
    if data.batch_size % dp:
        raise SystemExit(f"data.batch_size={data.batch_size} is not divisible by the {dp} processes{of}")
    if data.val_root is not None and data.val_batch_size % dp:
        raise SystemExit(f"data.val_batch_size={data.val_batch_size} is not divisible by the {dp} processes{of}")


def _make_val_pesq(task):
    """Host-side validation PESQ (ref models/vocoder.py:40-46): each clip and its generated audio, cut to
    the clip's length, resampled to 16 kHz and scored PESQ-WB.  fn((B, 1, T) fake, host batch) -> a list
    of MOS-LQO floats; a clip of length 0 and a degenerate one (all silence etc.) are skipped."""

    def run(fake: np.ndarray, batch: dict) -> list:
        out = []
        audio = np.asarray(batch["audio"])
        lengths = np.asarray(batch["lengths"])
        for i in range(audio.shape[0]):
            n = int(lengths[i])
            if n <= 0:
                continue
            ref16 = resample(audio[i, 0, :n], task.sampling_rate, 16000)
            deg16 = resample(fake[i, 0, :n], task.sampling_rate, 16000)
            try:
                out.append(pesq_metric(ref16, deg16, 16000, mode="wb"))
            except Exception:
                pass  # degenerate clip
        return out

    return run


class Timer:
    """Seconds of work queued on ``device`` between ``start`` and ``stop``: CUDA events on a card (read
    once the card is done), the host's clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans, self.host_s = [], 0.0

    def start(self) -> None:
        if self.cuda:
            self.spans.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
            self.spans[-1][0].record()
        else:
            self._t = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.spans[-1][1].record()
        else:
            self.host_s += time.perf_counter() - self._t

    def seconds(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.spans) / 1e3
        return self.host_s


def validate(state: gan.TrainState, eval_fn, val_batches: list[dict], pesq_fn, device: torch.device):
    """One validation, as the JAX loop runs it: for each batch the eval forward, then host PESQ on its
    clips.  -> (scalars, (first batch's fake (B, 1, T) numpy, its host batch))."""
    mels, pesqs, first = [], [], None
    fwd = Timer(device)
    pesq_s = 0.0
    for vb in val_batches:
        batch = to_device(vb, device)
        fwd.start()
        vmetrics, fake = eval_fn(state, batch)
        fwd.stop()
        fake = fake.cpu().numpy()
        mels.append(float(vmetrics["val/metrics/mel"]))
        if first is None:
            first = (fake, vb)
        if pesq_fn is not None:
            t = time.perf_counter()
            pesqs.extend(pesq_fn(fake, vb))
            pesq_s += time.perf_counter() - t
    scalars = {"val/metrics/mel": float(np.mean(mels))}
    if pesqs:
        scalars["val/metrics/pesq"] = float(np.mean(pesqs))
    scalars["perf/val_forward_s"] = fwd.seconds()
    scalars["perf/val_pesq_s"] = pesq_s
    return scalars, first


def log_val_media(metrics_logger: MetricsLogger, step: int, task, first, device: torch.device) -> None:
    """GT and generated audio, and their log-mel figure, of the first validation clip (JAX's
    report_val_metrics analogue)."""
    fake, vb = first
    n = int(vb["lengths"][0])
    if n <= 0:
        return
    gt = np.asarray(vb["audio"])
    metrics_logger.add_audio(step, "val/audio/gt", gt[0, 0, :n], task.sampling_rate)
    metrics_logger.add_audio(step, "val/audio/pred", fake[0, 0, :n], task.sampling_rate)
    nf = max(n // task.hop_length, 1)
    with torch.no_grad():
        mels = [gan.loss_mel_transform(task, torch.from_numpy(np.ascontiguousarray(a[:1, 0])).to(device))
                [0, :, :nf].cpu().numpy() for a in (gt, fake)]
    fig = plot_mel(mels, ["ground truth", "generated"])
    if fig is not None:
        metrics_logger.add_figure(step, "val/mel", fig)


class ProfileWindow:
    """``run.profile_steps``: ``torch.profiler`` over the steps [start, stop), written as a Chrome trace to
    ``<workdir>/profile/trace_<start>_<stop>.json`` (the JAX package's ``jax.profiler`` window).  Call
    ``before(step)`` before each step and ``after(step)`` after it, with the state's step; ``close`` ends a
    window that the run's end cut short."""

    def __init__(self, steps, workdir: Path, device: torch.device):
        self.steps = tuple(steps) if steps else None
        if self.steps is not None and (len(self.steps) != 2 or not 0 <= self.steps[0] < self.steps[1]):
            raise ValueError(f"run.profile_steps must be (start, stop) with 0 <= start < stop, got {steps!r}")
        self.path = None if self.steps is None else workdir / "profile" / f"trace_{self.steps[0]}_{self.steps[1]}.json"
        self.device = device
        self._prof = None

    def before(self, step: int) -> None:
        if self.steps is not None and step == self.steps[0] and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def after(self, step: int) -> None:
        if self._prof is not None and step >= self.steps[1]:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self.path))
        log(f"profiler trace written to {self.path}")


def train(cfg: TrainConfig, device: str | torch.device = "cuda") -> gan.TrainState:
    """Train on ``device`` until ``run.max_steps`` (or an early stop); the final state.  Under torchrun,
    this rank's part of a data-parallel run (``cuda``: the card of its local rank)."""
    device = dist.init_from_env(device)  # before anything touches a card
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to train on the CPU")
    world, main = dist.world_size(), dist.is_main()
    check_parallel(cfg, world)
    grid = tp.make_grid(cfg.run.model_parallel)
    group, shares = grid.data, grid.data_size
    set_precision(cfg.run.precision)
    task = cfg.task
    workdir = Path(cfg.run.workdir)
    ckpt = CheckpointManager(workdir / "checkpoints", save_interval_steps=cfg.run.ckpt_interval)
    _check_config(cfg, workdir, ckpt)
    dist.barrier()  # every rank has read config.json before rank 0 writes it
    if main:
        workdir.mkdir(parents=True, exist_ok=True)
        (workdir / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))

    state = gan.create_train_state(task, cfg.run.seed, device, grid.model)
    latest = ckpt.saved_step
    if cfg.run.ckpt_path is not None and cfg.run.resume_weights_only:
        CheckpointManager(cfg.run.ckpt_path).restore_weights_only(state)
        log(f"resumed weights only from {cfg.run.ckpt_path}")
    elif latest is not None:
        ckpt.restore(state, latest)
        log(f"auto-resumed from step {state.step}")
    dist.broadcast_modules([state.generator], group)  # the ranks that hold the same shard
    dist.broadcast_modules([state.discriminators],
                           group if tp.is_sharded(state.discriminators) else dist.world_group())
    n_g = sum(p.numel() for p in state.generator.parameters())
    n_d = sum(p.numel() for p in state.discriminators.parameters())
    held = {k: sum(tp.held_bytes(m, opt).values())
            for k, m, opt in (("generator", state.generator, state.opt_g),
                              ("discriminators", state.discriminators, state.opt_d))}
    log(f"params: generator {n_g:,}, discriminators {n_d:,} on {device}"
        + (" (this rank's shards)" if grid.model is not None else "")
        + f"; bytes held: generator {held['generator']:,}, discriminators {held['discriminators']:,}")
    if grid.model is not None:
        log(f"tensor parallel: model groups of {grid.model.size} processes "
            f"({torch.distributed.get_backend()}), {shares} of data parallelism")
    if group is not None:
        log(f"data parallel: {shares} {'processes' if grid.model is None else 'model groups'} "
            f"({torch.distributed.get_backend()}), {cfg.data.batch_size // shares} of the batch's "
            f"{cfg.data.batch_size} items each")

    step_fn = gan.make_train_step(task, group=group)
    eval_fn = gan.make_eval_step(task)
    target_len = task.hop_length * task.num_frames
    profile = ProfileWindow(cfg.run.profile_steps if main else None, workdir, device)
    host_it = batch_iterator(_build_train_sampler(cfg), batch_size=cfg.data.batch_size // shares,
                             target_length=target_len, seed=cfg.run.seed, host_index=grid.data_rank,
                             start_step=state.step, num_workers=cfg.data.num_workers, template_fn=template_fn(task))
    extractor = HubertFeatureExtractor(task.generator.hubert, device) if task.family == "ssl" else None
    validating = cfg.data.val_root is not None
    # Rank 0's model group runs the validation's forwards, rank 0 its PESQ and logs.
    val_batches = _build_val_batches(cfg, extractor) if grid.data_rank == 0 else None
    pesq_fn = _make_val_pesq(task) if cfg.run.val_pesq and main else None
    metrics_logger = MetricsLogger(workdir)
    prefetcher = DevicePrefetcher(host_it, device, depth=2)  # its thread starts here; closed in the finally
    ssl_time = Timer(device)  # the backbone's time in the log window

    def run_step():
        profile.before(state.step)
        batch = next(prefetcher)
        if extractor is not None:
            ssl_time.start()
            batch["ssl_features"] = extractor(batch["audio"][:, 0, :])
            ssl_time.stop()
        metrics = step_fn(state, batch)
        profile.after(state.step)
        return metrics

    start_step = state.step
    log(f"starting training at step {start_step} / {cfg.run.max_steps}")
    try:
        if start_step < cfg.run.max_steps:
            run_step()  # the first step, which builds the kernels, apart
            ckpt.save(state.step, state)
        ssl_time = Timer(device)
        t0 = time.perf_counter()
        window = max(cfg.run.log_interval, 1)
        best_val, stale_vals = float("inf"), 0
        while state.step < cfg.run.max_steps:
            metrics = run_step()
            step = state.step
            if step % window == 0:
                scalars = {k: float(v) for k, v in metrics.items()}  # waits for the card
                sps = window / (time.perf_counter() - t0)
                scalars["perf/steps_per_s"] = sps
                scalars["perf/audio_s_per_s"] = sps * cfg.data.batch_size * target_len / task.sampling_rate
                scalars["perf/input_wait_s"] = prefetcher.wait_seconds(reset=True)
                if extractor is not None:
                    scalars["perf/ssl_features_s"] = ssl_time.seconds()
                    ssl_time = Timer(device)
                metrics_logger.write(step, scalars)
                log(f"step {step}: g={scalars['train/generator/all']:.3f} "
                    f"d={scalars['train/discriminator/all']:.3f} mel={scalars['train/generator/mel']:.3f} "
                    f"({sps:.2f} steps/s, {scalars['perf/audio_s_per_s']:.1f} audio-s/s)")
                t0 = time.perf_counter()
            if validating and step % cfg.run.val_interval == 0:
                stop = False
                if val_batches:  # rank 0's model group, when the validation root holds clips
                    val_scalars, first = validate(state, eval_fn, val_batches, pesq_fn, device)
                if val_batches and main:
                    val_mel = val_scalars["val/metrics/mel"]
                    metrics_logger.write(step, val_scalars)
                    log(f"step {step}: val mel-L1 {val_mel:.4f}" + (
                        f", PESQ {val_scalars['val/metrics/pesq']:.3f}" if "val/metrics/pesq" in val_scalars else ""))
                    if cfg.run.early_stop_patience is not None:
                        if val_mel < best_val - 1e-6:
                            best_val, stale_vals = val_mel, 0
                        else:
                            stale_vals += 1
                            stop = stale_vals >= cfg.run.early_stop_patience
                    if stop:
                        log(f"early stop: no val improvement in {stale_vals} validations")
                    else:
                        log_val_media(metrics_logger, step, task, first, device)
                if dist.broadcast_flag(stop, device):  # the other ranks wait here for rank 0's validation
                    break
            ckpt.save(step, state)
        if ckpt.saved_step != state.step:
            ckpt.save(state.step, state, force=True)
        log(f"kernel launches: {json.dumps(launch_counts())}")
        dist.barrier()
    except BaseException as e:
        log(f"training failed at step {state.step}: {type(e).__name__}: {e}")
        if main:
            (workdir / "crash.log").write_text(traceback.format_exc())
        raise
    finally:
        profile.close()
        ckpt.wait()
        prefetcher.close()
        metrics_logger.close()
    return state
