"""Data-parallel training on the CPU: two gloo ranks against one process on the concatenated batch.

The JAX package holds its data-parallel step (a ``data=4`` mesh) to its single-device step
(``tests/test_sharding.py``), and the port's other tests hold the port's single-process step to JAX's;
this file closes the chain with two small processes and no JAX run.  One spawn of two ranks (a module
fixture; ``tests/torch_dp_ranks.py`` is the ranks' side, one torch thread each) runs every case on its
rows of each global batch of 4 and saves what it saw; each test compares a case with the same code run as
one process on the whole batch.

Training cases (two steps, so Adam's moments and the EMA carry over; the same crop starts, drawn alike on
every rank): the trainer's tiny BigVGAN (K1's plain path), the vae (eps draws), the vqvae and the ssl
family (EMA codebooks).  bnvae has no trainable generator (its posterior is dormant, in the JAX package
too), so its encoder is a component case: BatchNorm statistics, eps draws, gradients, running statistics.
The other component cases are the spectral convergence (a ratio of norms over the batch), an EMA update
and the batch-axis draws; a per-rank version of any of them fails its case.  Only the order of sums
differs between the two sides, so losses agree within ``LOSS_RTOL``, gradients within ``GRAD_REL_L2``
(relative L2 of each tensor against the largest of the module's), updated weights and buffers within
``STATE_RTOL`` / ``STATE_ATOL``, and draws and generator states exactly.

Then ``cli.train`` under torchrun with two gloo ranks: two steps with a validation, a resume to three,
only rank 0 writing; the refusals by name; ``cli.bench_scaling --virtual 2``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_dp_ranks as ranks
from tests.test_torch_family_cli import BASE, FAMILIES
from tests.test_torch_ssl_cli import generator_overrides
from tests.test_torch_trainer import TINY, _wavs
from tests.torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)
from vocoder_tpu_torch import config as tconfig
from vocoder_tpu_torch.data.dataset import batch_iterator
from vocoder_tpu_torch.parallel import dist
from vocoder_tpu_torch.train import gan, trainer
from vocoder_tpu_torch.utils.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-5
STATE_RTOL, STATE_ATOL = 1e-5, 1e-7
PROCESS_TIMEOUT = 240  # seconds a spawned run may take before the test fails

SSL = [o for o in generator_overrides("none") if "model_name_or_path" not in o]
PLAN = [
    {"name": "gan", "model": "bigvgan", "family": "gan", "overrides": TINY},
    {"name": "vae", "model": "hifigan", "family": "vae",
     "overrides": [*BASE, *[f"task.generator.{o}" for o in FAMILIES["vae"][1]]]},
    {"name": "vqvae", "model": "hifigan", "family": "vqvae",
     "overrides": [*BASE, *[f"task.generator.{o}" for o in FAMILIES["vqvae"][1]]]},
    {"name": "ssl", "model": "hifigan", "family": "ssl", "overrides": [*BASE, *SSL]},
]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in dist.ENV}
    env.update(PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")])), OMP_NUM_THREADS="1",
               **extra)
    return env


def _start(args: list[str], **env) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(**env))


def _wait(procs) -> list[str]:
    """Each process's standard output, once every one ended within the timeout and exited 0; else their
    errors in the failure."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=PROCESS_TIMEOUT))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    failed = [(p.args, p.returncode, err[-3000:]) for p, (_, err) in zip(procs, outs) if p.returncode != 0]
    assert not failed, failed
    return [out for out, _ in outs]


BENCH = ["vocoder_tpu_torch.cli.bench_scaling", "--virtual", "2", "--tiny", "--meshes", "1,2,4", "--iters", "1"]


@pytest.fixture(scope="module")
def bench():
    """``BENCH``'s process, started by the first test that asks for it so that it runs beside that test's
    ranks; ``test_bench_scaling_virtual_ranks_print_jax_keys`` reads its output."""
    proc = _start(BENCH)
    yield proc
    proc.kill()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every case on two gloo ranks ({name: [rank 0's, rank 1's]}) and as one process ({name: result})."""
    out = tmp_path_factory.mktemp("dp")
    (out / "plan.json").write_text(json.dumps(PLAN))
    port = str(dist.free_port())
    procs = [_start(["tests.torch_dp_ranks", "cases", str(out / "plan.json"), str(out)], RANK=str(r),
                    LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost", MASTER_PORT=port)
             for r in range(WORLD)]
    one = {spec["name"]: ranks.run_case(spec) for spec in PLAN}  # one process, meanwhile
    one.update({name: ranks.run_component(name) for name in ranks.COMPONENTS})
    _wait(procs)
    per_rank = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {name: [per_rank[r][name] for r in range(WORLD)] for name in one}, one


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _grad_rel_l2(got: dict, want: dict, module: str) -> float:
    """The largest per-tensor L2 distance over the module's largest gradient norm."""
    keys = [k for k in want if k.startswith(module)]
    scale = max(np.linalg.norm(want[k]) for k in keys)
    return max(np.linalg.norm(got[k] - want[k]) for k in keys) / scale


@pytest.mark.parametrize("name", [spec["name"] for spec in PLAN])
def test_two_ranks_step_equals_one_process_on_the_whole_batch(spawned, name):
    """Both steps' losses and grad norms, the step-1 gradients, the weights and buffers after step 2 and
    the noise generator's state; the ranks hold the same state, bit for bit."""
    dp, one = spawned[0][name], spawned[1][name]
    for r in range(WORLD):
        assert dp[r]["starts"] == one["starts"]
        for got, want in zip(dp[r]["metrics"], one["metrics"]):
            assert set(got) == set(want)
            worst = max(want, key=lambda k: _rel(got[k], want[k]))
            assert _rel(got[worst], want[worst]) <= LOSS_RTOL, (worst, got[worst], want[worst])
        assert set(dp[r]["grads"]) == set(one["grads"])
        for module in ("generator", "discriminators"):
            assert _grad_rel_l2(dp[r]["grads"], one["grads"], module) <= GRAD_REL_L2, module
        for key, want in one["state"].items():
            np.testing.assert_allclose(dp[r]["state"][key], want, rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=key)
        np.testing.assert_array_equal(dp[r]["noise"], one["noise"])
    for key in one["state"]:
        np.testing.assert_array_equal(dp[0]["state"][key], dp[1]["state"][key], err_msg=key)


@pytest.mark.parametrize("name", ranks.COMPONENTS)
def test_batch_coupled_parts_are_the_global_batch(spawned, name):
    """Per-row outputs against the rank's rows of one process's; global values, gradients of shared
    parameters, buffers and generator states against one process's."""
    dp, one = spawned[0][name], spawned[1][name]
    for r in range(WORLD):
        assert set(dp[r]) == set(one)
        for key, want in one.items():
            got = dp[r][key]
            if key.startswith("rows/"):
                want = ranks.rows(want, r, WORLD)
            if key in ("noise", "rows/codes") or key.startswith("rows/drop_path") or name == "draws":
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=key)


def test_two_rank_cli_train_writes_on_rank_0_and_resumes(tmp_path, bench):
    """``torchrun --nproc_per_node 2 -m vocoder_tpu_torch.cli.train --device cpu``: 2 steps with a
    validation at 2, then a resume to 3 (unlogged: the first step of a run is apart).  Only rank 0 wrote
    under the workdir; one metrics line a log step and a validation; rank r trained on ``batch_iterator(host_index=r)``'s batches, from the step
    it resumed at; both ranks restored the checkpoint rank 0 wrote; the validation's mel-L1 and PESQ are
    one process's on the step-2 weights.  Rank 1 waits after each checkpoint it declines, so rank 0 has
    written 3.pt before rank 1 decides on the final save: both still decide alike, and both exit."""
    rng = np.random.default_rng(0)
    _wavs(tmp_path / "train", 4, rng)
    _wavs(tmp_path / "val", 2, rng)
    work = tmp_path / "run"
    argv = ["--model", "bigvgan", "--device", "cpu", f"data.train_roots=('{tmp_path / 'train'}',)",
            f"data.val_root={tmp_path / 'val'}", f"run.workdir={work}", *TINY]
    for tag, steps in (("first", 2), ("resume", 3)):
        _wait([_start(["torch.distributed.run", "--standalone", "--nproc_per_node", str(WORLD), "-m",
                       "tests.torch_dp_ranks", "cli", str(tmp_path), tag, *argv, f"run.max_steps={steps}"])])
    rec = {(tag, r): torch.load(tmp_path / f"{tag}_rank{r}.pt", weights_only=False)
           for tag in ("first", "resume") for r in range(WORLD)}

    assert all(not rec[(tag, 1)]["writes"] for tag in ("first", "resume"))
    written = {Path(p).name for tag in ("first", "resume") for _, p in rec[(tag, 0)]["writes"]}
    assert {"config.json", "metrics.jsonl", "2.pt", "3.pt"} <= written
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], "val/metrics/mel" in r) for r in records] == [(2, False), (2, True)]
    assert CheckpointManager(work / "checkpoints").steps() == [2, 3]

    cfg = tconfig.build_train_config("bigvgan", overrides=argv[4:])
    sampler = trainer._build_train_sampler(cfg)
    t = cfg.task.hop_length * cfg.task.num_frames
    for r in range(WORLD):
        for tag, start, n in (("first", 0, 2), ("resume", 2, 1)):
            it = batch_iterator(sampler, batch_size=cfg.data.batch_size // WORLD, target_length=t,
                                seed=cfg.run.seed, host_index=r, start_step=start)
            want = [next(it)["audio"] for _ in range(n)]
            got = rec[(tag, r)]["batches"]
            assert len(got) >= n and all(np.array_equal(g, w) for g, w in zip(got, want)), (tag, r)

    state = gan.create_train_state(cfg.task, cfg.run.seed, "cpu")
    CheckpointManager(work / "checkpoints").restore(state, 2)
    assert rec[("resume", 0)]["restored"] == rec[("resume", 1)]["restored"] == [ranks.digest(state)]
    assert rec[("resume", 0)]["step"] == rec[("resume", 1)]["step"] == 3
    assert rec[("resume", 0)]["final"] == rec[("resume", 1)]["final"]

    val, _ = trainer.validate(state, gan.make_eval_step(cfg.task), trainer._build_val_batches(cfg),
                              trainer._make_val_pesq(cfg.task), torch.device("cpu"))
    logged = records[1]
    for key in ("val/metrics/mel", "val/metrics/pesq"):
        assert logged[key] == pytest.approx(val[key], rel=1e-6), key


@pytest.mark.parametrize("override,message", [
    ("run.model_parallel=3", r"run.model_parallel=3 does not divide the number of processes \(2\)"),
    ("run.data_parallel=4", r"run.data_parallel=4 must be the number of processes \(2\)"),
    ("data.batch_size=3", "data.batch_size=3 is not divisible by the 2 processes"),
    ("data.val_batch_size=5", "data.val_batch_size=5 is not divisible by the 2 processes"),
])
def test_layouts_two_processes_cannot_run_are_refused_by_name(override, message):
    cfg = tconfig.build_train_config("bigvgan", overrides=[*TINY, "data.val_root=/val", override])
    with pytest.raises(SystemExit, match=message):
        trainer.check_parallel(cfg, WORLD)
    trainer.check_parallel(tconfig.build_train_config("bigvgan", overrides=[*TINY, "data.val_root=/val"]), WORLD)


def test_cli_train_refuses_tensor_parallelism_in_one_process(tmp_path):
    """One process cannot hold two shards: run.model_parallel=2 is refused by name before the workdir is made."""
    with pytest.raises(SystemExit, match=r"run.model_parallel=2 does not divide the number of processes \(1\)"):
        trainer.train(tconfig.build_train_config("bigvgan", overrides=[
            *TINY, f"data.train_roots=('{tmp_path}',)", f"run.workdir={tmp_path / 'run'}", "run.model_parallel=2"]),
            "cpu")
    assert not (tmp_path / "run").exists()


def test_bench_scaling_virtual_ranks_print_jax_keys(bench):
    """``cli.bench_scaling --virtual 2 --tiny --meshes 1,2,4 --iters 1``: one line for dp 1 and 2 each
    with the JAX package's keys, none for 4 (more than the ranks)."""
    lines = [json.loads(line) for line in _wait([bench])[0].splitlines()]
    assert [r["data_parallel"] for r in lines] == [1, 2]
    for r in lines:
        assert set(r) == {"data_parallel", "step_ms", "audio_s_per_s", "efficiency"}
        assert r["step_ms"] > 0 and r["audio_s_per_s"] > 0
    assert lines[0]["efficiency"] == 1.0
