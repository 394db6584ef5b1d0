"""Extend the config-5 cohort world with RefSeq+fungal+viral-scale decoy
genomes (VERDICT r4 #3: the 100M run must exercise the index dimension,
not a 444k-k-mer toy). Appends two decoy phyla (12 fungal + 12 viral
species, 5.5 Mbp each = 132 Mbp) to the existing taxonomy/refs WITHOUT
touching existing dense taxon ids, so the cohort reads' planted truth
stays valid; decoy k-mers are random draws in 4^21 space (disjoint from
the read-source genomes w.h.p.). The combined w=8 index lands in the
deep-gather regime (~29M stored minimizers, q8 nb 2^20, 0.54 GB).

Run: PYTHONPATH=src python experiments/extend_c5_world.py WORLD_DIR
"""
import sys

import numpy as np

D = sys.argv[1]
N_SP = 12
GL = 5_500_000

rows = [l.rstrip("\n").split("\t")
        for l in open(f"{D}/taxonomy.tsv") if not l.startswith("#")]
T = max(int(r[0]) for r in rows)
new = []
nid = T
for dom in ("Fungi", "Viruses"):
    nid += 1
    phy = nid
    new.append((phy, 1, "phylum", f"{dom}_P"))
    nid += 1
    gen = nid
    new.append((gen, phy, "genus", f"{dom}_G"))
    for s in range(N_SP):
        nid += 1
        new.append((nid, gen, "species", f"{dom}_sp{s}"))

with open(f"{D}/taxonomy_big.tsv", "w") as fh:
    fh.write("#taxid\tparent\trank\tname\n")
    for r in rows:
        fh.write("\t".join(r) + "\n")
    for tid, par, rk, name in new:
        fh.write(f"{tid}\t{par}\t{rk}\t{name}\n")

species = [(tid, name) for tid, _, rk, name in new if rk == "species"]
bases = np.frombuffer(b"ACGT", dtype=np.uint8)
with open(f"{D}/refs_decoy.fasta", "wb") as fh:
    for i, (tid, name) in enumerate(species):
        rng = np.random.default_rng(777_000 + i)
        seq = bases[rng.integers(0, 4, size=GL)]
        fh.write(f">decoy{i}|taxid={tid} {name}\n".encode())
        for off in range(0, GL, 80):
            fh.write(seq[off:off + 80].tobytes())
            fh.write(b"\n")
print(f"wrote {len(species)} decoy genomes ({len(species) * GL / 1e6:.0f} "
      f"Mbp) + taxonomy_big.tsv ({nid} taxa)")
