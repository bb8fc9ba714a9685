"""Vocos on the card: a b16 forward with lengths synchronises nothing with the host, and each row's own
samples equal its item's forward alone.

Marked ``cuda``: the test asks the ``cuda_device`` fixture for the card and skips inside it where there is
none.  Run on an H100 with ``python -m pytest tests/test_torch_vocos_cuda.py -m cuda --noconftest``; it
imports no JAX.  The Hann window of the iSTFT lives on the card as the head's buffer, so no forward copies
it from the host; a blocking copy would show as a synchronisation under ``set_sync_debug_mode("warn")``.
"""

import warnings

import pytest
import torch

from vocoder_tpu_torch.models.vocos import Vocos, VocosConfig

pytestmark = pytest.mark.cuda

TINY = dict(backbone=dict(input_channels=16, depths=(1, 1, 3, 1), dims=(8, 16, 24, 32)),
            head=dict(dim=32, n_fft=64, hop_length=16, win_length=64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_b16_forward_with_lengths_does_not_synchronise(cuda_device):
    torch.manual_seed(0)
    model = Vocos(VocosConfig(**TINY), device=cuda_device).eval()
    frames = [20 + 5 * i for i in range(16)]
    mel = torch.randn(16, 16, max(frames), device=cuda_device) - 5.0
    for i, f in enumerate(frames):
        mel[i, :, f:] = 0.0
    lens = torch.tensor(frames, dtype=torch.int32, device=cuda_device)
    with torch.inference_mode():
        model(mel, frame_lengths=lens)  # the first call makes cuFFT's plans and picks cuDNN's algorithms
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = model(mel, frame_lengths=lens)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        alone = [model(mel[i : i + 1, :, :f])[0, 0] for i, f in enumerate(frames)]
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    print(f"synchronisations in one b16 Vocos forward with lengths: {len(syncs)}")
    assert syncs == [], syncs
    hop = TINY["head"]["hop_length"]
    for i, f in enumerate(frames):
        assert _rel_l2(out[i, 0, : f * hop], alone[i]) < 1e-5
