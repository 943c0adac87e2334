"""megahit_tpu_torch: the megahit_tpu assembler ported to PyTorch and CUDA.

A port of megahit_tpu (the JAX/TPU package beside it, which stays the
reference) to PyTorch on an NVIDIA H100. It keeps megahit_tpu's module
layout, its on-disk artifacts and its contig output. The count hot path
runs two CUDA kernels written for Hopper (``core/kernels.py``,
``csrc/``); the rest is torch tensor passes and host numpy with the same
native C++ helpers.

This slice ports one k of the default pipeline, reads to
``final.contigs.fa``: build lib -> count -> mercy -> SdBG -> tip removal,
unitigs, host cleaning engine, contig output.

Package layout (as in megahit_tpu):
  core/      packing, k-mer ops, the count kernels and their plain versions
  csrc/      CUDA C++ sources of the kernels (sm_90a)
  io/        FASTA/FASTQ reading, sequence libraries, contig I/O
  graph/     k-mer counting, mercy, SdBG, unitigs, cleaning, output
  native/    host C++ helpers (g++ at first use), loaded with ctypes
  pipeline/  one-k driver, options, checkpointing
  utils/     logging, timers, host thread budget
  convert.py megahit_tpu state (as numpy arrays) -> this package's objects
"""

__version__ = "0.1.0"
