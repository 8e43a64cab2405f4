"""dsm_tpu — a distributed string-mining framework on JAX accelerators.

Re-implements the capabilities of the HIITMetagenomics dsm-framework
(Valimaki & Puglisi WABI'12; Seth et al. Bioinformatics 2014) with a design
built for a vector accelerator: flat small-alphabet occ tables instead of Huffman wavelet
trees, a batched LF/rank primitive instead of pointer-chasing, a
breadth-first interval wavefront instead of a recursive DFS, and JAX
collectives over a device mesh instead of hand-rolled TCP streams.

Subpackages
-----------
ops      : core numeric kernels (rank/occ, LF, suffix array, entropy)
index    : FASTA input, sequence transform, FM-index build/save/load
mining   : wavefront trie enumeration, cross-sample merge, output gates
parallel : device-mesh sharding of the sample / prefix axes
net      : reference-wire-protocol compatibility layer (C++ + ctypes)
post     : distance-matrix post-processing (smtxt2entropy equivalent)
cli      : command-line entry points (dsm build / mine / serve / ...)
utils    : config, logging, counters, checkpoint helpers
"""

__version__ = "0.1.0"
