"""Quickstart: associative arrays in five minutes (paper §II-B, Fig. 2)
— the JAX package's ``examples/quickstart.py`` on the port.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

import torch

from ..core import Assoc, StartsWith, graph, parse_tsv, val2col

# a tiny packet-header table (what stage 3 produces)
TSV = """id\tip.src\tip.dst\ttcp.dstport
p001\t1.1.1.1\t2.2.2.2\t80
p002\t1.1.1.1\t3.3.3.3\t443
p003\t2.2.2.2\t1.1.1.1\t80
p004\t3.3.3.3\t2.2.2.2\t6667
"""


def run() -> dict:
    """The example's steps; the tables as the text they print, the
    PageRank (on the device, ``repro_torch.device.get_device()``) as
    floats."""
    A = parse_tsv(TSV)              # dense associative array
    E = val2col(A, "|")             # columns become field|value, entries 1
    conns = graph.connections(E, "1.1.1.1")     # Fig. 2's operation
    Adj = graph.adjacency(E)        # E_src' * E_dst
    deg = graph.degree_table(E)     # stage 6's TedgeDeg
    src_block = E[:, StartsWith("ip.src|")]
    heavy = Adj > 0.5               # threshold filter
    pr = graph.pagerank(graph.square(Adj).device_coo(torch.float32),
                        num_iters=20)
    return {"dense": str(A), "incidence": str(E),
            "connections": str(conns), "adjacency": str(Adj),
            "degree": str(deg), "src_nnz": int(src_block.nnz),
            "edges": [tuple(t) for t in zip(*heavy.triples()[:2])],
            "pagerank": pr.cpu().tolist()}


def main() -> None:
    r = run()
    print("dense table:\n", r["dense"], "\n")
    print("incidence matrix:\n", r["incidence"], "\n")
    print("connections of 1.1.1.1:\n", r["connections"], "\n")
    print("directed adjacency:\n", r["adjacency"], "\n")
    print("degree table:\n", r["degree"], "\n")
    print("src block has", r["src_nnz"], "entries")
    print("edges:", r["edges"])
    print("pagerank:", [f"{v:.3f}" for v in r["pagerank"]])


if __name__ == "__main__":
    main()
