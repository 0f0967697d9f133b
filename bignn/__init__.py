"""bignn — a bi-level graph neural network framework in JAX.

Re-implements the capabilities of the reference
codeKgu/BiLevel-Graph-Neural-Network (BI-GNN, arXiv:2006.14002): an inner GNN
encodes each small "inner" graph (e.g. a drug molecule), a segment-pool readout
produces one embedding per inner graph, an outer GNN propagates those
embeddings over the interaction graph, and a pair scorer predicts links
(e.g. drug-drug interactions) against sampled negatives.

NOTE ON CITATIONS: the reference mount `/root/reference/` is empty in this
environment (see SURVEY.md header), so reference citations in this package
point at SURVEY.md sections / BASELINE.json lines, which reconstruct the
reference's structure, instead of reference file:line.

Architecture (not a port — SURVEY.md §1.2):
  - sparse/    static-shape padded CSR / sorted-edge formats (SURVEY T1)
  - ops/       sparse kernels: gather, segment reduce, SpMM, SDDMM
               (XLA compositions + Pallas kernels for the GPU)
               (SURVEY T2, BASELINE.json:5)
  - models/    pure-pytree GNN modules: GCN/GIN/GAT convs, readouts,
               edge scorer, losses (SURVEY T3)
  - data/      array-based dataset schema, synthetic generators, samplers
               (SURVEY T4)
  - train/     jit'd train step, optax, eval, checkpointing (SURVEY T5)
  - parallel/  mesh, data parallelism, edge partitioner, halo exchange
               (SURVEY T6 / P1-P2)
  - oracle/    NumPy reference implementation for parity tests (SURVEY T8)
"""

__version__ = "0.1.0"
