"""StrainScan-TPU: an accelerator-resident strain-level metagenomic
profiling engine.

A from-scratch JAX/XLA re-design of the capabilities of
liaoherui/StrainScan (k-mer based strain identification from short reads):

* build a reference database from strain genomes — Jaccard hierarchical
  clustering, a binary Cluster Search Tree (CST) with cluster-specific
  k-mer sets at every node, per-cluster strain-discriminating k-mer
  matrices and a cross-cluster overlap matrix;
* identify strains and their sequencing depths in FASTQ samples — one
  restricted k-mer count of the sample against the DB (an XLA
  hash-probe program replacing the jellyfish subprocess), a top-down CST
  search with coverage/abundance statistics and a binomial descent test,
  then an iterative Pre-Scan plus a positive Elastic-Net regression
  inside each detected multi-strain cluster.

Array-native design: k-mers are canonical-or-dual-orientation 2-bit-packed
uint64 values (carried as uint32 hi/lo pairs on device), the DB k-mer index
is a bucketed open-addressing hash table resident in device memory,
per-cluster k-mer×strain matrices are dense/CSR int8 matrices, and
all depth/coverage statistics and the Elastic-Net solve are jit-compiled
matrix algebra. Multi-device scaling shards the hash table over a
``jax.sharding.Mesh`` "index" axis and streams read batches data-parallel,
merging per-k-mer hit counts with ``psum``/``all_gather`` collectives.
"""

__version__ = "0.1.0"
