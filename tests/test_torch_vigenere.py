"""Parity of the port's hw3 Vigenère workload (``apps/vigenere.py``) and its
corpus (``apps/corpus.py``) with the JAX package, on the CPU.

Exact throughout: sanitised bytes, keys, ciphers, histograms, the top
digraphs with their tie order (lower code first), the float32
index-of-coincidence profile, key lengths, coset shifts, cracked texts and
the CLIs' files and key lines.
"""

import collections
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cme213_tpu.apps import corpus as j_corpus
from cme213_tpu.apps import vigenere as j_vg
from cme213_tpu_torch import models
from cme213_tpu_torch.apps import corpus
from cme213_tpu_torch.apps import vigenere as vg

ENGLISH_FREQ = np.array([
    8.17, 1.49, 2.78, 4.25, 12.70, 2.23, 2.02, 6.09, 6.97, 0.15, 0.77, 4.03,
    2.41, 6.75, 7.51, 1.93, 0.10, 5.99, 6.33, 9.06, 2.76, 0.98, 2.36, 0.15,
    1.97, 0.07,
])
ENGLISH_FREQ = ENGLISH_FREQ / ENGLISH_FREQ.sum()


def english_like(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.choice(26, size=n, p=ENGLISH_FREQ) + ord("a")).astype(
        np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def book() -> np.ndarray:
    data = corpus.load_corpus()
    assert data.size >= 1_200_000, "corpus must match mobydick scale"
    return data


# ------------------------------------------------------------ sanitise, keys

@pytest.mark.parametrize("raw", [b"Hello, World! 123 abcXYZ", b"!!!", b"abc",
                                 b"", bytes(range(256))],
                         ids=["mixed", "none-kept", "all-kept", "empty",
                              "every-byte"])
def test_sanitize_is_the_reference(raw):
    data = np.frombuffer(raw, dtype=np.uint8)
    out = vg.sanitize(data, device="cpu")
    assert out.dtype == np.uint8
    if raw:
        np.testing.assert_array_equal(out, j_vg.sanitize(data))
    else:
        assert out.size == 0
    if raw == b"Hello, World! 123 abcXYZ":
        assert bytes(out) == b"helloworldabcxyz"


@pytest.mark.parametrize("period,seed", [(7, 123), (1, 5), (40, 0)])
def test_generate_key_is_the_reference(period, seed):
    k = vg.generate_key(period, seed)
    np.testing.assert_array_equal(k, j_vg.generate_key(period, seed))
    assert (k >= 1).all() and (k <= 26).all()


def test_encode_decode_round_trip_and_parity():
    text = english_like(1000)
    shifts = vg.generate_key(5)
    enc = vg.encode(text, shifts, device="cpu")
    np.testing.assert_array_equal(enc, j_vg.encode(text, shifts))
    np.testing.assert_array_equal(vg.decode(enc, shifts, device="cpu"), text)
    assert (enc >= ord("a")).all() and (enc <= ord("z")).all()


# ------------------------------------------------------------ analytics

def test_letter_histogram_is_the_reference():
    text = english_like(20000, seed=3)
    hist = vg.letter_histogram(_t(text)).numpy()
    np.testing.assert_array_equal(
        hist, np.asarray(j_vg.letter_histogram(jnp.asarray(text))))
    np.testing.assert_array_equal(hist, np.bincount(text - ord("a"),
                                                    minlength=26))
    assert hist.argmax() == ord("e") - ord("a")


@pytest.mark.parametrize("text", [b"ababababac", b"abcdefghij" * 3,
                                  b"zz"], ids=["ab-ba", "ties", "short"])
def test_digraph_top20_ties_as_top_k(text):
    data = np.frombuffer(text, dtype=np.uint8)
    codes, counts = vg.digraph_top20(_t(data))
    j_codes, j_counts = j_vg.digraph_top20(jnp.asarray(data))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    if text == b"ababababac":
        assert list(codes[:2]) == [1, 26] and list(counts[:2]) == [4, 4]


def test_ioc_profile_and_key_length_are_the_reference():
    text = vg.encode(english_like(20000, seed=4), vg.generate_key(6),
                     device="cpu")
    prof = vg.ioc_profile(_t(text), max_lag=64).numpy()
    np.testing.assert_array_equal(
        prof, np.asarray(j_vg.ioc_profile(jnp.asarray(text), max_lag=64)))
    assert prof.dtype == np.float32
    assert vg.find_key_length(_t(text)) == \
        j_vg.find_key_length(jnp.asarray(text)) == 6
    assert vg.index_of_coincidence(_t(text), 6) == \
        j_vg.index_of_coincidence(jnp.asarray(text), 6)


def test_ioc_flat_vs_english():
    flat = (np.arange(26, dtype=np.uint8) + ord("a"))[
        np.tile(np.arange(26), 1000)]
    assert vg.index_of_coincidence(_t(flat), 3) < 1.3
    assert vg.index_of_coincidence(_t(english_like(26000, seed=5)), 3) > 1.6
    assert vg.find_key_length(_t(flat)) == \
        j_vg.find_key_length(jnp.asarray(flat)) == 26


@pytest.mark.parametrize("key_length", [1, 5, 13])
def test_coset_shifts_are_the_reference(key_length):
    shifts = vg.generate_key(key_length, seed=key_length)
    text = vg.encode(english_like(9001, seed=key_length), shifts,
                     device="cpu")
    out = vg.coset_shifts(_t(text), key_length).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(j_vg.coset_shifts(jnp.asarray(text), key_length)))
    np.testing.assert_array_equal(out, shifts % 26)


# ------------------------------------------------------------ drivers

@pytest.mark.parametrize("n,period,seed", [(60000, 6, 7), (30000, 1, 11)])
def test_crack_round_trip(n, period, seed):
    text = english_like(n, seed=seed)
    shifts = vg.generate_key(period, seed=99)
    cipher = vg.encode(text, shifts, device="cpu")
    res = vg.crack(cipher, device="cpu")
    ref = j_vg.crack(cipher)
    assert res.key_length == ref.key_length == period
    np.testing.assert_array_equal(res.shifts, np.asarray(ref.shifts))
    np.testing.assert_array_equal(res.plain_text, text)


def test_cli_round_trip_and_parity(tmp_path, capsys):
    """File-level create → solve (the PA3 §3.1 grading commands), the
    port's files and key lines equal to the JAX package's."""
    raw = tmp_path / "input.txt"
    body = english_like(60000, seed=19)
    noisy = np.insert(body, np.arange(0, body.size, 97), ord("!"))
    noisy.astype(np.uint8).tofile(str(raw))
    cipher_path = tmp_path / "cipher_text.txt"
    plain_path = tmp_path / "plain_text.txt"

    vg.main_create(["create", str(raw), "5"], out_path=str(cipher_path),
                   device="cpu")
    created = capsys.readouterr().out
    vg.main_solve(["solve", str(cipher_path)], out_path=str(plain_path),
                  device="cpu")
    solved = capsys.readouterr().out
    key = re.search(r"Key: (\w+)", created).group(1)
    assert key == re.search(r"Key: (\w+)", solved).group(1)
    np.testing.assert_array_equal(np.fromfile(plain_path, dtype=np.uint8),
                                  body)

    j_cipher = tmp_path / "j_cipher.txt"
    j_vg.main_create(["create", str(raw), "5"], out_path=str(j_cipher))
    assert capsys.readouterr().out == created
    assert j_cipher.read_bytes() == cipher_path.read_bytes()
    j_vg.main_solve(["solve", str(cipher_path)],
                    out_path=str(tmp_path / "j_plain.txt"))
    assert capsys.readouterr().out == solved


def test_cli_dispatch_and_errors(tmp_path, capsys, monkeypatch):
    raw = tmp_path / "in.txt"
    english_like(30000, seed=2).tofile(str(raw))
    monkeypatch.chdir(tmp_path)
    assert models.dispatch(["vigenere", str(raw), "4", "--device=cpu"]) == 0
    assert models.dispatch(["vigenere", "solve", "cipher_text.txt",
                            "--device=cpu"]) == 0
    assert "keyLength: 4" in capsys.readouterr().out
    assert vg.main(["vigenere"]) == 2
    assert vg.main(["vigenere", "missing.txt", "3", "--device=cpu"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vg.main(["vigenere", str(raw), "4"])


# ------------------------------------------------------------ corpus

def test_corpus_generator_is_the_reference():
    for n, seed in [(500, 0), (5_000, 11), (40_000, 7)]:
        data = corpus.make_english_corpus(n, seed)
        assert data == j_corpus.make_english_corpus(n, seed)
        assert len(data) >= n and data.decode("ascii")
        m = len(data)
        assert len(corpus.make_english_corpus(m, seed)) >= m


def test_shipped_corpus(book):
    """The repository's corpus is the generator's output (on the numpy that
    wrote it) and is what both packages load."""
    np.testing.assert_array_equal(book, j_corpus.load_corpus())
    assert corpus.load_corpus(3_000_000).size == 3_000_000
    assert os.path.samefile(corpus.corpus_path(), j_corpus.corpus_path())
    if np.__version__ == corpus.GENERATED_WITH_NUMPY:
        np.testing.assert_array_equal(
            book, np.frombuffer(corpus.make_english_corpus(), np.uint8))


def test_corpus_is_generated_where_the_file_is_absent(monkeypatch, tmp_path):
    monkeypatch.setattr(corpus, "corpus_path",
                        lambda: str(tmp_path / "none.txt"))
    data = corpus.load_corpus(10_000)
    assert data.size == 10_000
    np.testing.assert_array_equal(
        data, np.frombuffer(corpus.make_english_corpus(), np.uint8)[:10_000])


def test_corpus_statistics_are_english(book):
    clean = vg.sanitize(book, device="cpu")
    hist = np.bincount(clean - ord("a"), minlength=26)
    top = "".join(chr(ord("a") + i) for i in np.argsort(hist)[::-1][:2])
    assert top == "et"
    t = _t(clean)
    assert vg.index_of_coincidence(t, 1) < 1.2
    for lag in (3, 7):
        assert 1.6 < vg.index_of_coincidence(t, lag) < 2.6
    pairs = collections.Counter(zip(bytes(clean), bytes(clean)[1:]))
    top10 = {bytes(p).decode() for p, _ in pairs.most_common(10)}
    assert {"th", "he", "an", "er", "in"} <= top10


def test_crack_at_full_scale(book):
    clean, shifts, cipher = vg.create_cipher(book, 7, seed=42, device="cpu")
    res = vg.crack(cipher, device="cpu")
    assert res.key_length == 7
    np.testing.assert_array_equal(res.shifts % 26, shifts % 26)
    np.testing.assert_array_equal(res.plain_text, clean)
