"""glimmer_mg_tpu — a JAX metagenomics gene-prediction framework.

A from-scratch reimplementation of the capabilities of Glimmer-MG
(Kelley et al., NAR 40:1 e9, 2012; reference code at davek44/Glimmer-MG)
designed for accelerators: interpolated-context-model (ICM) scoring as
batched vectorized XLA walks, ORF enumeration and the gene event-graph
dynamic program as vectorized scans, and Phymm/Scimm-style classification
and clustering as dense read-by-model score matrices sharded over device
meshes with jax.sharding + shard_map.

Layout:
  models/    ICM, PWM (RBS motif), feature distributions (length/start/adj)
  ops/       compute kernels (JAX): ICM walk scoring, scans, device DP
  engine/    ORF finder, event DP, glimmer3/glimmer-mg prediction engines
  parallel/  mesh construction, ICM-bank sharding, collectives
  io/        FASTA, binary .icm codec, .motif/.features.txt/.predict files
  pipeline/  iterated training, metagenomics pipeline, ELPH-style motif finder
"""

__version__ = "0.1.0"
