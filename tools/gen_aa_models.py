"""Regenerate libpll2_jax/models/aa_data.py.

Dumps the published empirical AA replacement-model constants (exact doubles)
through the test oracle's compiled reference library, so our tables are
bit-identical to what the reference ships (and to PAML/RAxML/IQ-TREE, which
all embed the same published matrices). Run from the repo root:

    python tools/gen_aa_models.py
"""
import ctypes as ct
import sys

sys.path.insert(0, "tests")
import oracle  # noqa: E402

lib = oracle.load()

MODELS = ["dayhoff", "lg", "dcmut", "jtt", "mtrev", "wag", "rtrev", "cprev",
          "vt", "blosum62", "mtmam", "mtart", "mtzoa", "pmb", "hivb", "hivw",
          "jttdcmut", "flu", "stmtrev", "den"]
CITE = {
    "dayhoff": "Dayhoff, Schwartz & Orcutt 1978",
    "lg": "Le & Gascuel 2008 MBE 25:1307",
    "dcmut": "Kosiol & Goldman 2005 MBE 22:193",
    "jtt": "Jones, Taylor & Thornton 1992 CABIOS 8:275",
    "mtrev": "Adachi & Hasegawa 1996 J Mol Evol 42:459",
    "wag": "Whelan & Goldman 2001 MBE 18:691",
    "rtrev": "Dimmic et al. 2002 J Mol Evol 55:65",
    "cprev": "Adachi et al. 2000 J Mol Evol 50:348",
    "vt": "Mueller & Vingron 2000 J Comput Biol 7:761",
    "blosum62": "Henikoff & Henikoff 1992 PNAS 89:10915",
    "mtmam": "Yang, Nielsen & Hasegawa 1998 MBE 15:1600",
    "mtart": "Abascal, Posada & Zardoya 2007 MBE 24:1",
    "mtzoa": "Rota-Stabelli, Yang & Telford 2009 MPE 52:268",
    "pmb": "Veerassamy, Smith & Tillier 2003 J Comput Biol 10:997",
    "hivb": "Nickle et al. 2007 PLoS ONE 2:e503",
    "hivw": "Nickle et al. 2007 PLoS ONE 2:e503",
    "jttdcmut": "Kosiol & Goldman 2005 MBE 22:193",
    "flu": "Dang et al. 2010 BMC Evol Biol 10:99",
    "stmtrev": "Liu et al. 2014 PLoS ONE 9:e99120",
    "den": "Le & Vinh 2020 J Mol Evol 88:445",
}


def arr(name, n):
    return list((ct.c_double * n).in_dll(lib, name))


def fmt(vals, per=4, indent="    "):
    lines = []
    for i in range(0, len(vals), per):
        lines.append(indent + ", ".join(repr(v) for v in vals[i:i + per])
                     + ",")
    return "\n".join(lines)


out = []
out.append('"""Empirical amino-acid replacement models (20-state, PAML '
           'order).')
out.append("")
out.append("Published substitution-model constants: 190 upper-triangle "
           "exchangeability")
out.append("rates + 20 stationary frequencies per model, as distributed "
           "with the")
out.append("reference library (reference: "
           "/root/reference/src/maps.c:226-1286) and")
out.append("identical across phylogenetics packages (PAML/RAxML/IQ-TREE/"
           "phyml).")
out.append("Primary sources are cited per model. Generated file - do not "
           "edit by hand")
out.append('(see tools/gen_aa_models.py)."""')
out.append("import numpy as np")
out.append("")
for m in MODELS:
    out.append(f"# {m.upper()} - {CITE[m]}")
    out.append(f"AA_RATES_{m.upper()} = np.array([")
    out.append(fmt(arr(f"pll_aa_rates_{m}", 190)))
    out.append("])")
    out.append(f"AA_FREQS_{m.upper()} = np.array([")
    out.append(fmt(arr(f"pll_aa_freqs_{m}", 20)))
    out.append("])")
    out.append("")
for name in ("lg4m", "lg4x"):
    cite = "Le, Dang & Gascuel 2012 MBE 29:2921"
    rates = list((ct.c_double * (4 * 190)).in_dll(lib,
                                                  f"pll_aa_rates_{name}"))
    freqs = list((ct.c_double * (4 * 20)).in_dll(lib,
                                                 f"pll_aa_freqs_{name}"))
    out.append(f"# {name.upper()} (4-matrix mixture) - {cite}")
    out.append(f"AA_RATES_{name.upper()} = np.array([")
    for k in range(4):
        out.append("  [")
        out.append(fmt(rates[k * 190:(k + 1) * 190], indent="      "))
        out.append("  ],")
    out.append("])")
    out.append(f"AA_FREQS_{name.upper()} = np.array([")
    for k in range(4):
        out.append("  [")
        out.append(fmt(freqs[k * 20:(k + 1) * 20], indent="      "))
        out.append("  ],")
    out.append("])")
    out.append("")
open("libpll2_jax/models/aa_data.py", "w").write("\n".join(out))
print("written libpll2_jax/models/aa_data.py")
