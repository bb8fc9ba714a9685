"""Plain PyTorch references of what the benchmark's cells compute, frozen with the benchmark.

Each module here is written from the published descriptions of the models and
of the training step, as plain ``torch`` calls over a dict of parameter
tensors named by the reference state dict's keys (weight norm as its
``original0`` gain and ``original1`` direction).  Nothing here imports the
program under test, or takes anything it made: the benchmark gives both sides
the same state dict and the same inputs.

- ``ops``: convolutions under a ``Precision`` (fp32 with TF32 off, or the
  control's TF32), weight norm, the anti-aliased Snake, STFT magnitudes and
  the log-mel.
- ``bigvgan``, ``hifigan``: the generators' forwards and their parameter
  layouts with the seed recipe of their weights.
- ``gan``: the multi-period and multi-resolution discriminators, the GAN,
  feature-matching, MR-STFT and mel losses, AdamW, the warmup-cosine schedule
  and the generator-then-discriminator training step.
"""
