"""Deterministic English-like corpus (the reference's hw1/hw3 data).

Counterpart of ``cme213_tpu/apps/corpus.py``.  The reference ships a 1.2 MB
public-domain novel as the input of the shift-cipher and Vigenère units
(``hw/hw1/programming/mobydick.txt``); the framework ships a *generator*
instead: Zipf-weighted sampling over a vocabulary of real English words,
with sentence and paragraph structure, so the statistics the hw3 attack
needs come out right — unigram letter frequencies in English order (the
per-coset attack, ``solve_cipher.cu:214-248``), an index of coincidence of
~1.7 (the key-length detector, ``:187-208``) and the English top digraphs
(``:156-180``).

``load_corpus`` reads the repository's canonical 1.25 MB instance,
``examples/corpus.txt`` (a data file both packages read), and generates one
in memory with numpy where that file is absent.  ``python -m
cme213_tpu_torch.apps.corpus out.txt [n_bytes] [seed]`` writes a corpus.
"""

from __future__ import annotations

import numpy as np

# Vocabulary: ~320 common English words (function words first — in real
# English text the top ~100 words cover roughly half of all tokens, which
# is what drags the letter distribution to its familiar shape).  Sampled
# with Zipf weights 1/(rank + 2.7) so "the"/"of"/"and" dominate the way
# they do in running text.
_VOCAB = """
the of and a to in is was he that it his her you as had with for she on at
by which have or from this him but not they all were are we when your can
said there use an each do how their if will up other about out many then
them these so some would make like into time has look two more write go see
number no way could people my than first water been call who oil its now
find long down day did get come made may part over new sound take only
little work know place year live me back give most very after thing our
just name good sentence man think say great where help through much before
line right too mean old any same tell boy follow came want show also around
form three small set put end does another well large must big even such
because turn here why ask went men read need land different home us move
try kind hand picture again change off play spell air away animal house
point page letter mother answer found study still learn should world high
every near add food between own below country plant last school father keep
tree never start city earth eye light thought head under story saw left
night kept white children begin got walk example ease paper group always
music those both mark often until mile river car feet care second book
carry took science eat room friend began idea fish mountain stop once base
hear horse cut sure watch color face wood main open seem together next
while sea along might close something morning captain whale ship ocean
wind against pattern slow center love person money serve appear road map
rain rule govern pull cold notice voice unit power town fine certain fly
fall lead cry dark machine note wait plan figure star box noun field rest
correct able pound done beauty drive stood contain front teach week final
gave green quick develop sleep warm free minute strong special mind behind
clear tail produce fact street inch multiply nothing course stay wheel
full force blue object decide surface deep moon island foot system busy
test record boat common gold possible plane stead dry wonder laugh
thousand ago ran check game shape equate hot miss brought heat snow tire
bring yes distant fill east paint language among
""".split()

_ZIPF = 1.0 / (np.arange(len(_VOCAB)) + 2.7)
_ZIPF = _ZIPF / _ZIPF.sum()

# numpy version the shipped examples/corpus.txt was generated with: the
# Generator bit-stream is only guaranteed stable within a version, so the
# byte-equality drift test gates on it (statistics tests always run)
GENERATED_WITH_NUMPY = "2.0.2"


def make_english_corpus(n_bytes: int = 1_250_000, seed: int = 0,
                        line_width: int = 72) -> bytes:
    """Deterministic English-like text of (at least) ``n_bytes`` bytes.

    Sentences of 5–17 Zipf-sampled words, capitalized, comma roughly every
    8 words, period at the end; paragraphs of 3–7 sentences separated by a
    blank line; lines wrapped at ``line_width`` like a plain-text novel.
    """
    rng = np.random.default_rng(seed)
    # Draw word indices in bulk blocks; a block that runs dry mid-corpus
    # is extended from the same stream, so the output length can never
    # fall short of n_bytes whatever the sentence-length draws do.
    block = max(int(n_bytes / 4.5) + 64, 256)
    words = rng.choice(len(_VOCAB), size=block, p=_ZIPF)
    i = 0

    def next_words(k: int) -> np.ndarray:
        nonlocal words, i
        if i + k > words.size:
            words = np.concatenate(
                [words[i:], rng.choice(len(_VOCAB), size=block, p=_ZIPF)])
            i = 0
        w = words[i:i + k]
        i += k
        return w

    out: list[str] = []
    size = 1  # the trailing newline; kept exact so the >= n_bytes
    # guarantee holds even when the loop exits right at the boundary
    while size < n_bytes:
        para_sents = int(rng.integers(3, 8))
        para: list[str] = []
        for _ in range(para_sents):
            sent_len = int(rng.integers(5, 18))
            toks = [_VOCAB[w] for w in next_words(sent_len)]
            toks[0] = toks[0].capitalize()
            # a comma mid-sentence, where real prose would pause
            if sent_len >= 9:
                cut = int(rng.integers(3, sent_len - 2))
                toks[cut] = toks[cut] + ","
            para.append(" ".join(toks) + ".")
        text = _wrap(" ".join(para), line_width)
        out.append(text)
        # "\n\n" separators join paragraphs, so only non-first paragraphs
        # carry the extra 2 bytes — size tracks the emitted length exactly
        size += len(text) + (2 if len(out) > 1 else 0)
    return ("\n\n".join(out) + "\n").encode("ascii")


def _wrap(text: str, width: int) -> str:
    """Greedy line wrap (textwrap-free: no hyphenation, deterministic)."""
    lines: list[str] = []
    line = ""
    for tok in text.split(" "):
        if line and len(line) + 1 + len(tok) > width:
            lines.append(line)
            line = tok
        else:
            line = f"{line} {tok}" if line else tok
    if line:
        lines.append(line)
    return "\n".join(lines)


def corpus_path() -> str:
    """Path of the shipped canonical corpus (examples/corpus.txt)."""
    import os

    return os.path.join(os.path.dirname(__file__), "..", "..", "examples",
                        "corpus.txt")


def load_corpus(n_bytes: int | None = None) -> np.ndarray:
    """The shipped corpus as uint8; falls back to generating one in memory.

    With ``n_bytes``, tiles/truncates to exactly that many bytes (the
    cipher sweeps size their inputs this way).
    """
    import os

    path = corpus_path()
    if os.path.exists(path):
        data = np.fromfile(path, dtype=np.uint8)
    else:
        data = np.frombuffer(make_english_corpus(), dtype=np.uint8)
    if n_bytes is not None:
        reps = -(-n_bytes // data.size)
        data = np.tile(data, reps)[:n_bytes]
    return data


def main(argv: list[str]) -> int:
    out = argv[1] if len(argv) > 1 else "corpus.txt"
    n = int(argv[2]) if len(argv) > 2 else 1_250_000
    seed = int(argv[3]) if len(argv) > 3 else 0
    data = make_english_corpus(n, seed)
    with open(out, "wb") as f:
        f.write(data)
    print(f"wrote {out}: {len(data)} bytes")
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv))
