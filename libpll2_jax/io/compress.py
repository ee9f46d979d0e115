"""Alignment column (site-pattern) compression.

Deduplicates identical alignment columns before partition creation,
returning per-pattern weights and optionally the site->pattern back-map
(reference: /root/reference/src/compress.c:137-412). Semantics match the
reference exactly:

  * columns are compared by their charmap-ENCODED byte codes: when every
    state mask fits a byte (DNA/binary/gt10) the code IS the mask; wider
    maps (amino acids) are remapped to sequential codes in ASCII scan
    order of each distinct mask's first occurrence (compress.c:99-135
    remap_range);
  * unique patterns come out in lexicographic order of those codes (the
    reference radix-quicksorts encoded columns and keeps sorted order);
  * compressed sequences are re-decoded through the inverse charmap: the
    LOWEST ASCII character mapping to a code is its representative, except
    '-' always represents the gap state (compress.c:226-234);
  * illegal characters raise (PLL_ERROR_TIPDATA_ILLEGALSTATE).

The O(L log L) column sort is numpy C code (np.unique over the transposed
code matrix) — the vectorized replacement for the reference's hand-written
3-way radix quicksort (compress.c:40-97).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import constants as C


def _byte_codes(charmap: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(codes [256] uint32, decode table): reference encode()/remap_range/
    inv_charmap semantics (compress.c:99-135, 214-234)."""
    cm = np.asarray(charmap, dtype=np.uint64)
    codes = np.zeros(256, dtype=np.uint32)
    if int(cm.max()) < 256:
        codes[:] = cm.astype(np.uint32)
    else:
        seen = {}
        k = 1
        for i in range(256):
            m = int(cm[i])
            if not m:
                continue
            if m not in seen:
                seen[m] = k
                k += 1
            codes[i] = seen[m]

    decode = np.zeros(int(codes.max()) + 1, dtype="<U1")
    for i in range(256):
        if int(cm[i]):
            c = int(codes[i])
            if decode[c] == "" or i == ord("-"):
                decode[c] = chr(i)
    return codes, decode


def encode_msa(sequences: Sequence[str], charmap: np.ndarray) -> np.ndarray:
    """[count, length] uint64 state-mask matrix; raises on illegal chars."""
    count = len(sequences)
    length = len(sequences[0])
    out = np.empty((count, length), dtype=np.uint64)
    cm = np.asarray(charmap, dtype=np.uint64)
    for i, seq in enumerate(sequences):
        if len(seq) != length:
            raise C.PllError(C.ERROR_FASTA_NONALIGNED,
                             "sequences are not aligned")
        row = cm[np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)]
        if np.any(row == 0):
            bad = seq[int(np.argmax(row == 0))]
            raise C.PllError(C.ERROR_TIPDATA_ILLEGALSTATE,
                             f"Illegal state code \"{bad}\"")
        out[i] = row
    return out


def compress_site_patterns(sequences: Sequence[str],
                           charmap: np.ndarray,
                           return_map: bool = False
                           ) -> Tuple[List[str], np.ndarray,
                                      Optional[np.ndarray]]:
    """Returns (compressed_sequences, pattern_weights[, site_pattern_map]).

    site_pattern_map[site] = index of the pattern representing that site
    (pll_compress_site_patterns_msa, compress.c:403-412).
    """
    codes_tab, decode = _byte_codes(charmap)
    count = len(sequences)
    length = len(sequences[0])
    codes = np.empty((count, length), dtype=np.uint32)
    for i, seq in enumerate(sequences):
        if len(seq) != length:
            raise C.PllError(C.ERROR_FASTA_NONALIGNED,
                             "sequences are not aligned")
        row = codes_tab[np.frombuffer(seq.encode("latin-1"),
                                      dtype=np.uint8)]
        if np.any(row == 0):
            bad = seq[int(np.argmax(row == 0))]
            raise C.PllError(C.ERROR_TIPDATA_ILLEGALSTATE,
                             f"Illegal state code \"{bad}\"")
        codes[i] = row

    cols = codes.T                                      # [L, count]
    uniq, inverse, counts = np.unique(
        cols, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)

    comp_cols = decode[uniq.astype(np.int64)]           # [P, count] chars
    compressed = ["".join(comp_cols[:, j]) for j in range(count)]

    weights = counts.astype(np.int64)
    if return_map:
        return compressed, weights, inverse.astype(np.int64)
    return compressed, weights, None
