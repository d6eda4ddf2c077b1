"""Vigenère cipher workload: create and statistical crack (the reference's
hw3).

Counterpart of ``cme213_tpu/apps/vigenere.py`` (the Thrust pipelines of
``hw/hw3/programming/create_cipher.cu`` and ``solve_cipher.cu``):

- sanitising (``remove_copy_if`` over an ``upper_to_lower`` transform,
  ``create_cipher.cu:31-50,111-113``) is mask → exclusive scan → scatter
  stream compaction on the device;
- encode and decode are ``ops/elementwise.py``'s Vigenère ops;
- the letter histogram is the sort + ``upper_bound`` formulation
  (``solve_cipher.cu:131-154``);
- the key-length detector computes the index of coincidence by
  autocorrelation (``inner_product(text, text<<i)``, threshold 1.6, the
  spike confirmed at 2·k; ``solve_cipher.cu:187-208``) for every lag on the
  device, and thresholds the profile on the host;
- the frequency attack (``solve_cipher.cu:214-248``) takes every coset at
  once: the text as ``(rows, keyLength)``, a histogram a column, ``shift =
  argmax − ('e'−'a')``.

The functions that take numpy arrays run on ``device`` (default ``cuda``);
the CLIs take ``--device=cpu``.  Ties among the top digraphs go to the
lower code, as ``lax.top_k`` orders them (a stable descending sort), and
``argmax`` takes the first maximum in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import resolve_device
from ..ops.elementwise import vigenere_shift, vigenere_unshift
from ..ops.histogram import histogram_sort
from ..ops.scan import exclusive_scan

_A = ord("a")
_E_MINUS_A = ord("e") - ord("a")


def _to_device(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch wraps only writable arrays
        arr = arr.copy()
    return torch.from_numpy(arr).to(resolve_device(device))


# ---------------------------------------------------------------- sanitize

def _sanitize_device(raw: torch.Tensor):
    """Lowercase + keep-mask + scatter compaction, on ``raw``'s device.

    Rejected bytes go to a sacrificial slot one past the end of an
    (n+1)-wide buffer, so they never collide with a kept byte; that slot
    takes many writes and is dropped, so the scatter overwrites (never
    accumulates).  Returns the buffer's first n bytes and the kept count.
    """
    n = raw.shape[0]
    if n == 0:
        return raw, 0
    is_upper = (raw >= ord("A")) & (raw <= ord("Z"))
    low = torch.where(is_upper, raw + (ord("a") - ord("A")), raw)
    keep = (low >= ord("a")) & (low <= ord("z"))
    pos = exclusive_scan(keep.to(torch.int64))
    out = torch.zeros(n + 1, dtype=low.dtype, device=raw.device)
    out[torch.where(keep, pos, n)] = torch.where(keep, low, 0)
    return out[:-1], int(pos[-1] + keep[-1])


def sanitize(raw: np.ndarray, device=None) -> np.ndarray:
    """Uppercase → lowercase, everything but a-z stripped (the
    create_cipher.cu sanitiser).  Returns the compacted uint8 array."""
    raw = np.asarray(raw, dtype=np.uint8)
    out, count = _sanitize_device(_to_device(raw, device))
    return out[:count].cpu().numpy()


# ---------------------------------------------------------------- key gen

def generate_key(period: int, seed: int = 123) -> np.ndarray:
    """Period-length shift vector in [1, 26], via a minstd LCG, the engine
    of the reference (``thrust::minstd_rand`` + ``uniform_int_distribution
    (1,26)``, create_cipher.cu:121-130)."""
    state = seed % 2147483647 or 1
    shifts = []
    for _ in range(period):
        state = (16807 * state) % 2147483647
        shifts.append(1 + state % 26)
    return np.asarray(shifts, dtype=np.int32)


def encode(text: np.ndarray, shifts: np.ndarray, device=None) -> np.ndarray:
    return vigenere_shift(_to_device(text, device),
                          torch.from_numpy(np.asarray(shifts))).cpu().numpy()


def decode(text: np.ndarray, shifts: np.ndarray, device=None) -> np.ndarray:
    return vigenere_unshift(_to_device(text, device),
                            torch.from_numpy(np.asarray(shifts))
                            ).cpu().numpy()


# ---------------------------------------------------------------- analytics

def letter_histogram(text: torch.Tensor) -> torch.Tensor:
    """26-bin dense histogram by sort + searchsorted
    (solve_cipher.cu:131-154)."""
    return histogram_sort(text.to(torch.int64) - _A, 26)


def digraph_top20(text: torch.Tensor):
    """Top-20 letter bigrams of the 26² counts (solve_cipher.cu:162-182).
    Returns (codes, counts); code = first·26 + second; equal counts go
    lower code first."""
    a = text[:-1].to(torch.int64) - _A
    b = text[1:].to(torch.int64) - _A
    codes = a * 26 + b
    keep = codes[(codes >= 0) & (codes < 676)]
    counts = torch.bincount(keep, minlength=676).to(torch.int32)
    top = torch.sort(counts, descending=True, stable=True)
    return top.indices[:20].to(torch.int32), top.values[:20]


def _num_matches(text: torch.Tensor, lag: int) -> torch.Tensor:
    """``inner_product(text[:-lag], text[lag:], equal_to)``."""
    return (text[:-lag] == text[lag:]).sum() if lag < text.shape[0] \
        else torch.zeros((), dtype=torch.int64, device=text.device)


def index_of_coincidence(text: torch.Tensor, lag: int) -> float:
    n = text.shape[0]
    return int(_num_matches(text, lag)) / ((n - lag) / 26.0)


def ioc_profile(text: torch.Tensor, max_lag: int = 256) -> torch.Tensor:
    """The index of coincidence at every lag in [1, max_lag), float32, in
    one host round trip (the reference's detector makes one a lag)."""
    matches = torch.stack([_num_matches(text, lag)
                           for lag in range(1, max_lag)])
    lags = torch.arange(1, max_lag, device=text.device)
    n = text.shape[0]
    # XLA computes the reference's ``/ 26.0`` as a multiply by the float32
    # reciprocal of 26; so does this, for the same bits
    expect = (n - lags).to(torch.float32) * float(np.float32(1 / 26))
    return matches.to(torch.float32) / expect


def find_key_length(text: torch.Tensor, threshold: float = 1.6,
                    max_lag: int = 256) -> int:
    """IOC autocorrelation detector (solve_cipher.cu:187-208): the first
    spike gives a candidate k; a spike at exactly 2k confirms it; any other
    spike is an unusual pattern.  The thresholding keeps the reference's
    scan order, on the host, over the device's profile."""
    profile = ioc_profile(text, max_lag=max_lag).cpu().numpy()
    key_length = 0
    for lag in range(1, max_lag):
        if profile[lag - 1] > threshold:
            if key_length == 0:
                key_length = lag
            elif 2 * key_length == lag:
                return key_length
            else:
                raise ValueError("Unusual pattern in text!")
    raise ValueError("no key length found")


def coset_shifts(text: torch.Tensor, key_length: int) -> torch.Tensor:
    """Frequency attack on every coset at once (solve_cipher.cu:214-248):
    the text padded to a row multiple as (rows, key_length), so coset i is
    column i; a histogram a column; ``shift = argmax − ('e'−'a') (mod 26)``.
    """
    n = text.shape[0]
    rows = -(-n // key_length)
    letters = torch.full((rows * key_length,), -1, dtype=torch.int64,
                         device=text.device)
    letters[:n] = text.to(torch.int64) - _A
    bins = torch.arange(26, device=text.device)
    onehot = letters.view(rows, key_length)[..., None] == bins
    hist = onehot.sum(dim=0)                        # (key_length, 26)
    return (torch.argmax(hist, dim=1) - _E_MINUS_A) % 26


# ---------------------------------------------------------------- drivers

@dataclass
class CrackResult:
    key_length: int
    shifts: np.ndarray
    plain_text: np.ndarray


def crack(cipher_text: np.ndarray, device=None) -> CrackResult:
    """The solve pipeline (solve_cipher.cu main): IOC key-length detection,
    the all-coset attack, decode."""
    cipher_text = np.asarray(cipher_text, dtype=np.uint8)
    d_text = _to_device(cipher_text, device)
    key_length = find_key_length(d_text)
    shifts = coset_shifts(d_text, key_length).cpu().numpy()
    plain = vigenere_unshift(d_text, torch.from_numpy(shifts)).cpu().numpy()
    return CrackResult(key_length, shifts, plain)


def create_cipher(raw_text: np.ndarray, period: int, seed: int = 123,
                  device=None):
    """create_cipher.cu main: sanitise → key → encode.  Returns
    (clean_text, shifts, cipher_text)."""
    clean = sanitize(raw_text, device)
    shifts = generate_key(period, seed)
    cipher = encode(clean, shifts, device)
    return clean, shifts, cipher


def print_letter_frequencies(text: torch.Tensor) -> None:
    """Frequency table in the reference's format ("a: .03" a line and the
    sum, solve_cipher.cu:142-154)."""
    hist = letter_histogram(text).cpu().numpy()
    n = text.shape[0]
    print(f"Text length: {n}\n")
    for i in range(26):
        print(f"{chr(_A + i)}: {hist[i] / n}")
    print(f"\nSum of histogram: {hist.sum() / n}\n")


def print_digraph_table(text: torch.Tensor) -> None:
    """Top-20 bigrams ("kh: .001" style, solve_cipher.cu:177-182)."""
    codes, counts = digraph_top20(text)
    codes, counts = codes.cpu().numpy(), counts.cpu().numpy()
    total = text.shape[0] - 1
    for c, cnt in zip(codes, counts):
        print(f"{chr(_A + c // 26)}{chr(_A + c % 26)}:  {cnt / total}")


def key_string(shifts) -> str:
    """Printable key: shift s → letter chr(s mod 26 + 'a') (shift 26 ≡ 0
    prints 'a'); both CLIs use it, so round trips agree."""
    return "".join(chr((int(s) % 26) + _A) for s in shifts)


def main_create(argv, out_path: str = "cipher_text.txt", device=None):
    """CLI of create_cipher.cu:77-99: ``input.txt period`` → writes
    ``cipher_text.txt``."""
    path, period = argv[1], int(argv[2])
    raw = np.fromfile(path, dtype=np.uint8)
    _, shifts, cipher = create_cipher(raw, period, device=device)
    print("Key:", key_string(shifts))
    cipher.tofile(out_path)
    return 0


def main_solve(argv, out_path: str = "plain_text.txt", device=None):
    """CLI of solve_cipher.cu:103-274: ``cipher_text.txt`` → the statistics
    tables, the key and ``plain_text.txt``."""
    cipher = np.fromfile(argv[1], dtype=np.uint8)
    d_text = _to_device(cipher, device)
    print_letter_frequencies(d_text)
    print_digraph_table(d_text)
    result = crack(cipher, device)
    print(f"\nkeyLength: {result.key_length}")
    print("\nKey:", key_string(result.shifts), "\n")
    result.plain_text.tofile(out_path)
    return 0


def main(argv) -> int:
    """``vigenere [create] input.txt period`` encodes (the reference's
    create_cipher CLI), ``vigenere solve cipher_text.txt`` cracks
    (solve_cipher's); ``--device=cpu`` runs on the CPU."""
    device = None
    args = []
    for a in argv[1:]:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            args.append(a)
    if args and args[0] in ("create", "solve"):
        sub, args = args[0], args[1:]
    else:
        sub = "create"
    if (sub == "create" and len(args) != 2) or (sub == "solve"
                                                and len(args) != 1):
        print("usage: vigenere [create] input.txt period [--device=cpu]\n"
              "       vigenere solve cipher_text.txt [--device=cpu]")
        return 2
    try:
        if sub == "solve":
            return main_solve(["solve", *args], device=device)
        return main_create(["create", *args], device=device)
    except (OSError, ValueError) as e:
        print(f"error: {e}")
        return 2


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv))
