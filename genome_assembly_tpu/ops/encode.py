"""Base-pair codec and 2-bit packing primitives.

Encoding convention follows the reference exactly (binning.c:69-124):
codes are T=0, G=1, C=2, A=3; the base-4 MSB-first "score" of a string equals
its 2-bit packed integer; a higher score means a lexicographically *smaller*
string (because 'A' has the highest code).  The complement (A<->T, C<->G) of a
code c is ``3 - c``; note the reference's "reverse complement" is a
per-position complement *without* reversal (binning.c:1029-1040, SURVEY.md
2.1.1) -- fast mode uses the true reverse complement, parity mode the
reference's plain complement.

k-mers with k <= 31 pack into at most 62 bits.  JAX runs with 64-bit types
off by default, so a packed k-mer is carried as two uint32 lanes: ``hi`` holds the first
``k - min(k, 16)`` bases and ``lo`` the final ``min(k, 16)`` bases, both
MSB-first.  (hi, lo) compares lexicographically like the string scores.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

# Base characters indexed by numeric code (reference getbp, binning.c:69-88).
BASE_BY_CODE = "TGCA"

# ASCII -> code lookup. Unknown characters map to 3 ('A'), matching the
# reference's getval default (binning.c:107-109); as a convenience for
# fast-mode inputs, lowercase acgt also map to their real codes (the
# reference would score them as 'A' -- parity paths use the REF table).
_ASCII_TO_CODE = np.full(256, 3, dtype=np.uint8)
for _i, _ch in enumerate(BASE_BY_CODE):
    _ASCII_TO_CODE[ord(_ch)] = _i
    _ASCII_TO_CODE[ord(_ch.lower())] = _i

# getval-EXACT table (binning.c:91-111): only uppercase TGCA are real;
# every other byte (including lowercase acgt and 'N') scores as 3.
_ASCII_TO_CODE_REF = np.full(256, 3, dtype=np.uint8)
for _i, _ch in enumerate(BASE_BY_CODE):
    _ASCII_TO_CODE_REF[ord(_ch)] = _i

_CODE_TO_ASCII = np.frombuffer(BASE_BY_CODE.encode(), dtype=np.uint8).copy()


def encode_bytes(ascii_u8: jnp.ndarray) -> jnp.ndarray:
    """Map ASCII bytes to 2-bit codes (uint8). Device-side lookup."""
    table = jnp.asarray(_ASCII_TO_CODE)
    return jnp.take(table, ascii_u8.astype(jnp.int32), axis=0)


def decode_codes(codes: jnp.ndarray) -> jnp.ndarray:
    """Map 2-bit codes back to ASCII bytes."""
    table = jnp.asarray(_CODE_TO_ASCII)
    return jnp.take(table, codes.astype(jnp.int32), axis=0)


def complement(codes: jnp.ndarray) -> jnp.ndarray:
    """Per-position complement: code -> 3 - code (binning.c:1031-1039)."""
    return (3 - codes.astype(jnp.int32)).astype(codes.dtype)


def windowed_scores(codes: jnp.ndarray, n: int) -> jnp.ndarray:
    """Packed base-4 MSB-first scores of every length-``n`` window.

    Equivalent to the reference's getscore (binning.c:114-124) applied to each
    substring.  ``codes`` has shape [..., L]; the result has shape
    [..., L - n + 1] and dtype uint32.  Requires n <= 15 so the score fits a
    uint32 with headroom (2n bits <= 30).
    """
    if n > 15:
        raise ValueError(f"windowed_scores supports n <= 15, got {n}")
    length = codes.shape[-1]
    nwin = length - n + 1
    if nwin <= 0:
        raise ValueError(f"window {n} longer than sequence {length}")
    acc = jnp.zeros(codes.shape[:-1] + (nwin,), dtype=jnp.uint32)
    for j in range(n):
        acc = (acc << 2) | codes[..., j : j + nwin].astype(jnp.uint32)
    return acc


def _doubling_packs(codes: jnp.ndarray, max_span: int) -> dict:
    """Windowed packed values for power-of-two window sizes.

    packs[s][..., i] = 2-bit pack of codes[i : i + s] for s = 1, 2, 4, ...
    up to the largest power of two <= min(max_span, 16) (16 bases fill a
    uint32).  Each level combines two half-windows with one shift+or --
    log-depth instead of the naive O(k) chain, and the [.., L] arrays reuse
    each other so XLA fuses the whole pyramid.
    """
    length = codes.shape[-1]
    packs = {1: codes.astype(jnp.uint32)}
    s = 1
    while 2 * s <= min(max_span, 16):
        half = packs[s]
        n = length - 2 * s + 1
        packs[2 * s] = (half[..., :n] << (2 * s)) | half[..., s : s + n]
        s *= 2
    return packs


def _windowed_pack(packs: dict, n: int, nwin: int) -> jnp.ndarray:
    """Length-``n`` windowed pack (n <= 16) from the doubling pyramid."""
    acc = None
    offset = 0
    for s in sorted(packs, reverse=True):
        if s & n:
            piece = packs[s][..., offset : offset + nwin]
            acc = piece if acc is None else (acc << (2 * s)) | piece
            offset += s
    return acc if acc is not None else jnp.zeros_like(packs[1][..., :nwin])


def _doubling_rc_packs(codes: jnp.ndarray, max_span: int) -> dict:
    """Reverse-complement analogue of _doubling_packs.

    rcpacks[s][..., i] = 2-bit pack of reverse_complement(codes[i : i + s]).
    Combine rule: rc(A+B) = rc(B)+rc(A), so each level swaps the halves.
    """
    length = codes.shape[-1]
    packs = {1: (3 - codes.astype(jnp.int32)).astype(jnp.uint32)}
    s = 1
    while 2 * s <= min(max_span, 16):
        half = packs[s]
        n = length - 2 * s + 1
        packs[2 * s] = (half[..., s : s + n] << (2 * s)) | half[..., :n]
        s *= 2
    return packs


def _windowed_rc_pack(rcpacks: dict, n: int, nwin: int) -> jnp.ndarray:
    """Length-``n`` windowed reverse-complement pack from the rc pyramid.

    Pieces at increasing offsets land at increasingly significant bits
    (rc reverses piece order)."""
    acc = None
    offset = 0
    len_acc = 0
    for s in sorted(rcpacks, reverse=True):
        if s & n:
            piece = rcpacks[s][..., offset : offset + nwin]
            acc = piece if acc is None else (piece << (2 * len_acc)) | acc
            offset += s
            len_acc += s
    return acc if acc is not None else jnp.zeros_like(rcpacks[1][..., :nwin])


def pack_kmers_both(
    codes: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(hi, lo, rc_hi, rc_lo) for every k-window, from shared pyramids.

    rc lanes hold the true reverse complement of each window:
      rc(w)[0:n_hi] = rc(w[k-n_hi:]),  rc(w)[n_hi:] = rc(w[0:n_lo]).
    """
    length = codes.shape[-1]
    nwin = length - k + 1
    n_lo = min(k, 16)
    n_hi = k - n_lo
    packs = _doubling_packs(codes, max(n_lo, n_hi, 1))
    rcpacks = _doubling_rc_packs(codes, max(n_lo, n_hi, 1))
    if n_hi:
        hi = _windowed_pack(packs, n_hi, nwin)
        lo = _windowed_pack(packs, n_lo, length - n_lo + 1)[..., n_hi : n_hi + nwin]
        rhi = _windowed_rc_pack(rcpacks, n_hi, length - n_hi + 1)[..., n_lo : n_lo + nwin]
        rlo = _windowed_rc_pack(rcpacks, n_lo, nwin)
    else:
        hi = jnp.zeros(codes.shape[:-1] + (nwin,), dtype=jnp.uint32)
        lo = _windowed_pack(packs, n_lo, nwin)
        rhi = hi
        rlo = _windowed_rc_pack(rcpacks, n_lo, nwin)
    return hi, lo, rhi, rlo


def pack_kmers(codes: jnp.ndarray, k: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pack every length-``k`` window into (hi, lo) uint32 lanes, MSB-first.

    hi holds the first ``k - n_lo`` bases, lo the final ``n_lo = min(k, 16)``
    bases.  Shapes: [..., L] -> two arrays [..., L - k + 1].  Built from a
    shared doubling pyramid: O(log k) combine steps instead of O(k).
    """
    if k > 31:
        raise ValueError(f"pack_kmers supports k <= 31, got {k}")
    length = codes.shape[-1]
    nwin = length - k + 1
    if nwin <= 0:
        raise ValueError(f"k={k} longer than sequence {length}")
    n_lo = min(k, 16)
    n_hi = k - n_lo
    packs = _doubling_packs(codes, max(n_lo, n_hi, 1))
    if n_hi:
        hi = _windowed_pack(packs, n_hi, nwin)
        lo_full = _windowed_pack(packs, n_lo, length - n_lo + 1)
        lo = lo_full[..., n_hi : n_hi + nwin]
    else:
        hi = jnp.zeros(codes.shape[:-1] + (nwin,), dtype=jnp.uint32)
        lo = _windowed_pack(packs, n_lo, nwin)
    return hi, lo


def complement_packed(
    hi: jnp.ndarray, lo: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Complement of a packed k-mer: each 2-bit group c -> 3 - c.

    Equals ``mask - x`` per lane, i.e. XOR with the all-ones 2-bit mask.
    """
    n_lo = min(k, 16)
    n_hi = k - n_lo
    mask_lo = jnp.uint32((1 << (2 * n_lo)) - 1)
    mask_hi = jnp.uint32((1 << (2 * n_hi)) - 1)
    return hi ^ mask_hi, lo ^ mask_lo


def reverse_complement_u32(v: jnp.ndarray, n: int) -> jnp.ndarray:
    """True reverse complement of single-lane packed n-mers (n <= 15)."""
    comp = jnp.uint32((1 << (2 * n)) - 1) - v
    out = jnp.zeros_like(v)
    for j in range(n):
        out = out | (((comp >> (2 * j)) & 3) << (2 * (n - 1 - j)))
    return out


def reverse_complement_packed(
    hi: jnp.ndarray, lo: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """True reverse complement of packed k-mers (fast mode only).

    k is static, so the per-base regroup unrolls into shifts/ors that XLA
    fuses; elementwise over any shape.
    """
    n_lo = min(k, 16)
    n_hi = k - n_lo
    codes = []
    for j in range(n_hi):
        codes.append((hi >> (2 * (n_hi - 1 - j))) & 3)
    for j in range(n_lo):
        codes.append((lo >> (2 * (n_lo - 1 - j))) & 3)
    codes = [3 - c for c in codes]  # complement
    codes.reverse()  # reversal
    rhi = jnp.zeros_like(hi)
    for j in range(n_hi):
        rhi = (rhi << 2) | codes[j].astype(jnp.uint32)
    rlo = jnp.zeros_like(lo)
    for j in range(n_hi, k):
        rlo = (rlo << 2) | codes[j].astype(jnp.uint32)
    return rhi, rlo


# ---------------------------------------------------------------------------
# Host-side (numpy / Python int) helpers, used for decoding device results to
# strings and in tests.  Not on any hot path.
# ---------------------------------------------------------------------------


def encode_str(s: str) -> np.ndarray:
    """String -> uint8 code array (host)."""
    return _ASCII_TO_CODE[np.frombuffer(s.encode(), dtype=np.uint8)]


def encode_str_parity(s: str) -> np.ndarray:
    """String -> codes with the reference's EXACT getval semantics:
    only uppercase TGCA are real bases, every other byte is 3
    (binning.c:91-111).  Parity mode must use this table so non-ACGT
    and lowercase bytes score exactly as the reference scores them."""
    return _ASCII_TO_CODE_REF[np.frombuffer(s.encode("latin-1"), dtype=np.uint8)]


def decode_str(codes: np.ndarray) -> str:
    """uint8 code array -> string (host)."""
    return _CODE_TO_ASCII[np.asarray(codes, dtype=np.int64)].tobytes().decode()


def score_str(s: str) -> int:
    """Reference getscore of a string (binning.c:114-124), exact semantics
    including the default-to-'A' mapping for unknown characters (the
    reference's switch lists only uppercase TGCA, so lowercase bases are
    unknown too -- the REF table, not the lenient fast-mode one)."""
    score = 0
    for ch in s:
        score = score * 4 + int(_ASCII_TO_CODE_REF[ord(ch) & 0xFF])
    return score


def pack_str(s: str) -> int:
    """Packed integer of a string; identical to score_str by construction."""
    return score_str(s)


def unpack_int(value: int, n: int) -> str:
    """Packed integer -> length-n string (MSB-first)."""
    out = []
    for j in range(n - 1, -1, -1):
        out.append(BASE_BY_CODE[(value >> (2 * j)) & 3])
    return "".join(out)


def split_to_int(hi: int, lo: int, k: int) -> int:
    """(hi, lo) uint32 lanes -> single packed Python int."""
    n_lo = min(k, 16)
    return (int(hi) << (2 * n_lo)) | int(lo)


def int_to_split(value: int, k: int) -> tuple[int, int]:
    """Single packed int -> (hi, lo) uint32 lanes."""
    n_lo = min(k, 16)
    return value >> (2 * n_lo), value & ((1 << (2 * n_lo)) - 1)
