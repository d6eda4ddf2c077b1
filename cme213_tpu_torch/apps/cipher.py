"""Shift-cipher workload driver (the reference's hw1).

Counterpart of ``cme213_tpu/apps/cipher.py``: the pipeline of
``hw/hw1/programming/cipher.cu:127-282``.  Load (or synthesise) a text
corpus, replicate it ×16 so the device has enough work, run the host golden
and the three device variants (per byte, 4-byte and 8-byte packed lanes),
compare each with the golden byte for byte, and report each phase's time and
effective bandwidth.

The default corpus is the repository's 1.25 MB English-like text
(``examples/corpus.txt``, ``apps/corpus.py``), the scale of the reference's
public-domain novel (``hw/hw1/programming/mobydick.txt``, 1.2 MB).  Runs on
``cuda`` unless the caller passes ``device="cpu"`` (``--device=cpu``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..core import PhaseTimer, bandwidth_gbs, resolve_device
from ..ops import shift_cipher, shift_cipher_packed
from ..verify import check_exact, golden

_WORD_CHARS = np.frombuffer(b"etaoinshrdlucmfwypvbgkjqxz", dtype=np.uint8)
_WORD_FREQ = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3,
                       4.0, 2.8, 2.8, 2.4, 2.2, 2.4, 2.0, 1.9, 1.0, 1.5,
                       2.0, 0.8, 0.15, 0.1, 0.15, 0.07])
_WORD_FREQ = _WORD_FREQ / _WORD_FREQ.sum()

#: the three device variants, in the reference's order and with its labels
VARIANTS = (
    ("gpu shift cypher", lambda d, s: shift_cipher(d, s)),
    ("gpu shift cypher uint", lambda d, s: shift_cipher_packed(d, s, 4)),
    ("gpu shift cypher uint2", lambda d, s: shift_cipher_packed(d, s, 8)),
)


def make_corpus(length: int = 1 << 20, seed: int = 0) -> np.ndarray:
    """Deterministic letter-frequency byte soup (letters, spaces,
    newlines), for cheap in-memory test inputs; real runs use the
    word-level corpus (``apps/corpus.py``)."""
    rng = np.random.default_rng(seed)
    letters = rng.choice(_WORD_CHARS, size=length, p=_WORD_FREQ)
    spaces = rng.random(length) < 0.18
    letters[spaces] = ord(" ")
    letters[:: 4096] = ord("\n")
    return letters.astype(np.uint8)


def run_cipher(text: np.ndarray | None = None, shift: int = 17,
               replicate: int = 16, timer: PhaseTimer | None = None,
               out_path: str | None = None, device=None) -> bool:
    """True iff every device variant equals the host golden byte for byte.
    With ``out_path``, writes the enciphered bytes (the un-replicated
    prefix), the ``mobydick_enciphered.txt`` artifact (cipher.cu:262-275).
    """
    dev = resolve_device(device)
    timer = timer or PhaseTimer(verbose=True)
    if text is None:
        from .corpus import load_corpus

        text = load_corpus()
    # replicate ×16 "otherwise everything happens too quickly"
    # (cipher.cu:148-159)
    data = np.tile(text, replicate)
    n = data.size

    with timer.phase("host shift cypher"):
        ref = golden.host_shift_cipher(data, shift)

    with timer.phase("copy data to device") as ph:
        d_data = torch.from_numpy(data).to(dev)
        ph.block(d_data)

    ok = True
    for name, fn in VARIANTS:
        fn(d_data, shift)  # the first call stays outside the timed phase
        with timer.phase(name) as ph:
            out = fn(d_data, shift)
            ph.block(out)
        ms = timer.last_ms(name)
        # 1 read + 1 write a byte (the reference's bandwidth accounting)
        print(f"{name}: {bandwidth_gbs(2 * n, ms):.2f} GB/s")
        with timer.phase("copy from device"):
            host = out.cpu().numpy()
        res = check_exact(ref, host, name)
        if not res:
            print(f"Output of device {name} version and host version "
                  f"didn't match!")
            print(res.message)
            ok = False
    if ok and out_path is not None:
        ref[:text.size].tofile(out_path)
    return ok


def main(argv: list[str]) -> int:
    """CLI of the reference driver (cipher.cu:127-160): ``[input.txt
    [shift]] [--device=cuda|cpu]``: loads the text (the shipped corpus by
    default), replicates ×16, runs the host golden and every device variant,
    and writes ``<input>_enciphered.txt``."""
    args = [a for a in argv[1:] if not a.startswith("--")]
    device = None
    for a in argv[1:]:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--"):
            print(f"error: unknown option {a!r}")
            return 2
    text, out_path = None, None
    shift = 17
    if args:
        try:
            text = np.fromfile(args[0], dtype=np.uint8)
        except OSError as e:
            print(f"error: {e}")
            return 2
        out_path = f"{args[0].rsplit('.', 1)[0]}_enciphered.txt"
    if len(args) > 1:
        shift = int(args[1])
    ok = run_cipher(text=text, shift=shift, out_path=out_path, device=device)
    if out_path and ok:
        print(f"wrote {out_path}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
