"""A run with the timed path broken underneath comes out not correct (the check's own controls).

Each test skips the look for a card, drives the rest of a run on the CPU at a tiny size, with one fault
planted in the program, and reads ``correct`` false: an answer altered where it is produced (synthesis,
per request), a step that leaves the state unchanged, and half the batch left out with the mean taken
over the rest (training).  One card, so no exchange between cards to leave out."""

import pytest
import torch

from portbench import program


def _altered(model):
    """The model, each waveform it produces altered by one part in a hundred (a shifted copy added)."""
    forward = model.forward

    def altered(*args, **kw):
        out = forward(*args, **kw)
        return out + 1e-2 * out.roll(1, dims=-1)

    model.forward = altered
    return model


@pytest.mark.parametrize("workload", ["bigvgan-44k.synth-b16", "hifigan-44k.synth-b16", "bigvgan-44k.request-b1"])
def test_an_altered_answer_is_not_correct(workload, run_tiny, monkeypatch):
    assert run_tiny(workload, seconds=2.0)[0]["correct"]
    build = program.generator
    monkeypatch.setattr(program, "generator", lambda *a, **kw: _altered(build(*a, **kw)))
    result, _ = run_tiny(workload, seconds=2.0)
    assert not result["correct"] and result["failed"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(run_tiny, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    result, _ = run_tiny("bigvgan-44k.train-b16")
    assert not result["correct"]
    assert result["checked"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(run_tiny, monkeypatch):
    build = program.train_state

    def halved(*args, **kw):
        task, state, step = build(*args, **kw)
        g_phase = step.g_phase

        def g_half(state, batch, crop_start=None):
            half = batch["audio"].shape[0] // 2
            return g_phase(state, {k: v[:half] for k, v in batch.items()}, crop_start)

        step.g_phase = g_half
        return task, state, step

    monkeypatch.setattr(program, "train_state", halved)
    result, _ = run_tiny("bigvgan-44k.train-b16")
    assert not result["correct"]
