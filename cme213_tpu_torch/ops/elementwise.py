"""Elementwise cipher ops: flat data parallelism and lane-packing variants.

Counterpart of ``cme213_tpu/ops/elementwise.py`` (the reference's hw1
cipher kernels, ``hw/hw1/programming/cipher.cu:64-92``, and the hw3
Vigenère transforms).  The per-byte shift is one wrapping ``uint8`` add;
the packed variants move 4 bytes a lane: the bytes are viewed as
``int32`` words and the shift is added as ``(s<<24)|(s<<16)|(s<<8)|s``
(``cipher.cu:231``).  Two's-complement addition gives the bits of the
reference's ``uint32`` add, so a byte that overflows carries into the next
byte of its word exactly as there (shift 255 over a byte ≥ 1), and the
top byte's carry leaves the word.  ``width=8`` is two such words, as the
reference's uint2 kernel shifts ``.x`` and ``.y`` apart (``:85-92``).

Semantics: unsigned-char wrapping add, as the host golden
(``cipher.cu:53-60``), wherever no byte overflows; the packed variants
equal the JAX package's bit for bit in every case.
"""

from __future__ import annotations

import torch


def _packed_shift(shift) -> int:
    """The shift replicated into every byte of a 32-bit word, as the
    reference's ``uint32`` ``s | s<<8 | s<<16 | s<<24``, returned as the
    ``int32`` with those bits."""
    s = int(shift) & 0xFFFFFFFF
    rep = 0
    for k in range(4):
        rep |= (s << (8 * k)) & 0xFFFFFFFF
    return rep - (1 << 32) if rep >= 1 << 31 else rep


def _check_u8(data: torch.Tensor) -> None:
    if data.dtype != torch.uint8:
        raise TypeError(f"cipher ops take uint8 data, got {data.dtype}")


def shift_cipher(data: torch.Tensor, shift) -> torch.Tensor:
    """Per-byte wrapping shift of a uint8 tensor."""
    _check_u8(data)
    return data + (int(shift) % 256)


def shift_cipher_packed(data: torch.Tensor, shift,
                        width: int = 4) -> torch.Tensor:
    """Packed-lane shift: ``width`` ∈ {4, 8} bytes a lane.

    ``width=4`` mirrors the uint kernel, ``width=8`` the uint2 kernel (two
    32-bit words, each shifted alone).  The length must be divisible by
    ``width`` (the reference guarantees it by replicating the corpus ×16,
    ``cipher.cu:148-159``)."""
    _check_u8(data)
    if width not in (4, 8):
        raise ValueError(f"width must be 4 or 8, got {width}")
    if data.numel() % width:
        raise ValueError(f"length {data.numel()} is not a multiple of "
                         f"width {width}")
    words = data.contiguous().view(torch.int32).view(-1, width // 4)
    return (words + _packed_shift(shift)).view(torch.uint8).view(-1)


def shift_cipher_batched(data: torch.Tensor,
                         shifts: torch.Tensor) -> torch.Tensor:
    """B same-length shifts at once: ``data`` a (B, n) uint8 stack,
    ``shifts`` a (B,) vector; each lane equals ``shift_cipher`` of it."""
    _check_u8(data)
    return data + shifts.to(device=data.device).remainder(256).to(
        torch.uint8)[:, None]


def shift_cipher_packed_batched(data: torch.Tensor, shifts: torch.Tensor,
                                width: int = 4) -> torch.Tensor:
    """Batched packed-lane shift: (B, n) stack, a shift a lane, n divisible
    by ``width``; each lane equals ``shift_cipher_packed`` of it."""
    _check_u8(data)
    if width not in (4, 8):
        raise ValueError(f"width must be 4 or 8, got {width}")
    b, n = data.shape
    if n % width:
        raise ValueError(f"length {n} is not a multiple of width {width}")
    reps = torch.tensor([_packed_shift(s) for s in shifts.tolist()],
                        dtype=torch.int32, device=data.device)
    words = data.contiguous().view(torch.int32)
    return (words + reps[:, None]).view(torch.uint8).view(b, n)


def saxpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y ← α·x + y, the product and the sum each rounded: two kernels, no
    fused multiply-add (``torch.add(y, x, alpha=α)`` may contract)."""
    alpha = torch.tensor(alpha, dtype=x.dtype).item()  # rounded as x
    return x * alpha + y


def parallel_sum(x: torch.Tensor) -> torch.Tensor:
    """Full reduction (a tree reduction; its association is the
    library's)."""
    return torch.sum(x)


def _periodic(text: torch.Tensor, shifts: torch.Tensor):
    """``text - 'a'`` and the key ``shifts[i % period]``, both int32."""
    n = text.shape[0]
    shifts = shifts.to(device=text.device)
    idx = torch.arange(n, device=text.device) % shifts.shape[0]
    s = shifts[idx].to(torch.int32)
    return text.to(torch.int32) - ord("a"), s


def vigenere_shift(text: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Vigenère encode over lowercase bytes with a periodic key:
    ``(c - 'a' + s) % 26 + 'a'`` (``hw/hw3/programming/create_cipher.cu:
    54-73,135-144``)."""
    c, s = _periodic(text, shifts)
    return ((c + s) % 26 + ord("a")).to(torch.uint8)


def vigenere_unshift(text: torch.Tensor,
                     shifts: torch.Tensor) -> torch.Tensor:
    """Vigenère decode: ``(c - 'a' + 26 - s % 26) % 26 + 'a'``
    (``hw/hw3/programming/solve_cipher.cu:94-101``)."""
    c, s = _periodic(text, shifts)
    return ((c + 26 - s % 26) % 26 + ord("a")).to(torch.uint8)
