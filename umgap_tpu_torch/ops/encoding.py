"""Integer encodings for DNA, amino acids and codons (a copy of the
numpy part of ``umgap_tpu.ops.encoding``).

DNA codes: A=0 C=1 G=2 T=3, anything else N=4 (reference
src/dna/mod.rs:34-44). AA codes: 'A'..'Z' -> 0..25, '*' -> 26, '-' and
any other byte -> 27; 31 is padding. A 9-mer of 5-bit AA codes packs into
45 bits, split 20/25 over two int32 lanes.

The genetic code tables are NCBI's public standard data, indexed by
codon in T,C,A,G base order (src/dna/translation.rs:47-104).
"""

from __future__ import annotations

import numpy as np

DNA_A, DNA_C, DNA_G, DNA_T, DNA_N = 0, 1, 2, 3, 4

DNA_FROM_BYTE = np.full(256, DNA_N, dtype=np.uint8)
for _ch, _code in zip(b"ACGT", (DNA_A, DNA_C, DNA_G, DNA_T)):
    DNA_FROM_BYTE[_ch] = _code
BYTE_FROM_DNA = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()

# complement: A<->T, C<->G, N->N
DNA_COMPLEMENT = np.array([DNA_T, DNA_G, DNA_C, DNA_A, DNA_N], dtype=np.uint8)


def encode_dna(seq: str | bytes) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    return DNA_FROM_BYTE[np.frombuffer(seq, dtype=np.uint8)]


def decode_dna(codes: np.ndarray) -> str:
    return BYTE_FROM_DNA[codes].tobytes().decode()


def pack_dna4(codes: np.ndarray) -> np.ndarray:
    """Pack DNA codes (0..4) two per byte along the last axis, high nibble
    first: the host-to-device wire format. Odd lengths pad with N."""
    if codes.shape[-1] % 2:
        pad = [(0, 0)] * (codes.ndim - 1) + [(0, 1)]
        codes = np.pad(codes, pad, constant_values=DNA_N)
    even = codes[..., 0::2].astype(np.uint8)
    odd = codes[..., 1::2].astype(np.uint8)
    return (even << 4) | odd


AA_STOP = 26  # '*'
AA_UNKNOWN = 27  # '-' and any unsupported byte
AA_PAD = 31  # padding / no symbol

AA_FROM_BYTE = np.full(256, AA_UNKNOWN, dtype=np.uint8)
for _i in range(26):
    AA_FROM_BYTE[ord("A") + _i] = _i
AA_FROM_BYTE[ord("*")] = AA_STOP

_AA_DECODE = ([chr(ord("A") + i) for i in range(26)]
              + ["*", "-", "?", "?", "?", ""])


def encode_aa(seq: str | bytes) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode()
    return AA_FROM_BYTE[np.frombuffer(seq, dtype=np.uint8)]


def decode_aa(codes: np.ndarray) -> str:
    return "".join(_AA_DECODE[int(c)] for c in codes)


GENETIC_CODES: dict[int, tuple[str, str, str]] = {
    1: ("universal",
        "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "---M---------------M---------------M----------------------------"),
    2: ("vertebrate_mitochondrial",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
        "--------------------------------MMMM---------------M------------"),
    3: ("yeast_mitochondrial",
        "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "----------------------------------MM----------------------------"),
    4: ("mold_mitochondrial",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "--MM---------------M------------MMMM---------------M------------"),
    5: ("invertebrate_mitochondrial",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
        "---M----------------------------MMMM---------------M------------"),
    6: ("ciliate_nuclear",
        "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "-----------------------------------M----------------------------"),
    9: ("echinoderm_mitochondrial",
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
        "-----------------------------------M---------------M------------"),
    10: ("euplotid_nuclear",
         "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "-----------------------------------M----------------------------"),
    11: ("bacterial",
         "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "---M---------------M------------MMMM---------------M------------"),
    12: ("alternative_yeast_nuclear",
         "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "-------------------M---------------M----------------------------"),
    13: ("ascidian_mitochondrial",
         "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
         "---M------------------------------MM---------------M------------"),
    14: ("flatworm_mitochondrial",
         "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
         "-----------------------------------M----------------------------"),
    15: ("blepharisma_macronuclear",
         "FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "-----------------------------------M----------------------------"),
    16: ("chlorophycean_mitochondrial",
         "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "-----------------------------------M----------------------------"),
    21: ("trematode_mitochondrial",
         "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
         "-----------------------------------M---------------M------------"),
    22: ("scenedesmus_mitochondrial",
         "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "-----------------------------------M----------------------------"),
    23: ("thraustochytrium_mitochondrial",
         "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--------------------------------M--M---------------M------------"),
}

# Codon order in the table strings is T,C,A,G; our codes are A,C,G,T.
_TCAG_FROM_DNA = np.array([2, 1, 3, 0], dtype=np.int64)


class TranslationTable:
    """One genetic code as 125-entry tables over codons
    ``n0*25 + n1*5 + n2`` of our DNA codes: ``aa[codon]`` is the AA code
    (AA_UNKNOWN for any codon with an N, src/dna/translation.rs:125-132),
    ``start[codon]`` marks start codons."""

    def __init__(self, number: int):
        if number not in GENETIC_CODES:
            raise ValueError(f"Unknown table: {number}")
        self.number = number
        name, aas, starts = GENETIC_CODES[number]
        self.name = name
        self.aas = aas
        self.starts = starts
        aa = np.full(125, AA_UNKNOWN, dtype=np.uint8)
        start = np.zeros(125, dtype=bool)
        for idx in range(64):
            t0, t1, t2 = idx // 16, (idx // 4) % 4, idx % 4
            codes = [int(np.where(_TCAG_FROM_DNA == t)[0][0])
                     for t in (t0, t1, t2)]
            codon = codes[0] * 25 + codes[1] * 5 + codes[2]
            aa[codon] = AA_FROM_BYTE[ord(aas[idx])]
            start[codon] = starts[idx] == "M"
        self.aa = aa
        self.start = start

    def translate_frame(self, dna_codes: np.ndarray,
                        methionine: bool = False) -> np.ndarray:
        """Host translation of one frame (codons are chunks of 3, a
        trailing partial codon is dropped; src/dna/translation.rs:136-144)."""
        n = (len(dna_codes) // 3) * 3
        c = dna_codes[:n].reshape(-1, 3).astype(np.int64)
        idx = c[:, 0] * 25 + c[:, 1] * 5 + c[:, 2]
        out = self.aa[idx]
        if methionine:
            out = np.where(self.start[idx], AA_FROM_BYTE[ord("M")], out)
        return out

    def show(self) -> str:
        """The table as ``translate -s`` prints it
        (TranslationTable::print, src/dna/translation.rs:147-174)."""
        lines = [f"{self.name}={self.number}"]
        base = "TCAG"
        rows = {
            "AAs": self.aas,
            "Starts": self.starts,
            "Base1": "".join(base[i // 16] for i in range(64)),
            "Base2": "".join(base[(i // 4) % 4] for i in range(64)),
            "Base3": "".join(base[i % 4] for i in range(64)),
        }
        for name, row in rows.items():
            lines.append(f"{name:<6} = {row}")
        return "\n".join(lines)


_TABLE_CACHE: dict[int, TranslationTable] = {}


def get_table(number: int) -> TranslationTable:
    if number not in _TABLE_CACHE:
        _TABLE_CACHE[number] = TranslationTable(number)
    return _TABLE_CACHE[number]
