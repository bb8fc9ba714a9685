"""Write the committed Ogg/Vorbis fixture and its expected decode.

    python -m vocoder_tpu_torch.tools.vorbis_fixture   # needs libvorbisenc and libvorbisfile

``tests/fixtures/vorbis_q06_stereo.ogg`` is 0.5 s of a seeded stereo tone at
44.1 kHz, encoded at quality 0.6 by ``data/ogg.write_ogg``;
``vorbis_q06_stereo.npy`` is libvorbisfile's decode of it (float32,
(2, 22050)).  A host without the codec libraries, which can neither encode
a fixture nor run libvorbisfile, holds its numpy decoder
(``data/vorbis.read_ogg_pure``) against this pair.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from vocoder_tpu_torch.data import ogg

FIXTURE = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / "vorbis_q06_stereo.ogg"
EXPECTED = FIXTURE.with_suffix(".npy")
RATE, SECONDS, QUALITY, SEED = 44100, 0.5, 0.6, 9


def signal() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    t = np.arange(int(RATE * SECONDS)) / RATE
    x = 0.3 * np.sin(2 * np.pi * 220.0 * t + 2.0 * np.sin(2 * np.pi * 5.0 * t)) + 0.1 * np.sin(2 * np.pi * 660.0 * t)
    x = x + 0.01 * rng.standard_normal(t.size)
    return np.stack([x, 0.8 * np.roll(x, 64)]).astype(np.float32)


def main() -> None:
    if not (ogg.encoder_available() and ogg.system_decoder_available()):
        raise SystemExit("needs libvorbisenc and libvorbisfile")
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    ogg.write_ogg(FIXTURE, signal(), RATE, quality=QUALITY)
    pcm, sr = ogg.read_ogg_pull(FIXTURE)
    assert sr == RATE and pcm.shape == (2, int(RATE * SECONDS)), (sr, pcm.shape)
    np.save(EXPECTED, pcm.astype(np.float32))
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes) and {EXPECTED}")


if __name__ == "__main__":
    main()
