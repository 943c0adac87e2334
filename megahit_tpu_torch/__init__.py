"""megahit_tpu_torch: the megahit_tpu assembler ported to PyTorch and CUDA.

A port of megahit_tpu (the JAX/TPU package beside it, which stays the
reference) to PyTorch on an NVIDIA H100. It keeps megahit_tpu's module
layout, its on-disk artifacts and its contig output. The count hot path
runs two CUDA kernels written for Hopper (``core/kernels.py``,
``csrc/``), and the sort network's two merge kernels sit beside them
(``core/sortnet.py``, off the assembly path as in megahit_tpu); the rest
is torch tensor passes and host numpy with the same native C++ helpers.

It runs the default multi-k pipeline, reads to ``final.contigs.fa``:
build lib -> count -> mercy -> SdBG -> tip removal, unitigs, cleaning
(on the card, or the host engine on the CPU), contig output at k_min,
then per rung local assembly, iterate and the contig-union graph; graphs
above the -m budget build out of core. Each stage also runs on its own
(``stage_cli.py``), with the toolkit in ``tools.py``. Not ported yet:
multi-GPU.

Package layout (as in megahit_tpu):
  core/      packing, k-mer ops, the kernels' wrappers and plain versions
  csrc/      CUDA C++ sources of the kernels (sm_90a)
  io/        FASTA/FASTQ reading, sequence libraries, contig I/O
  graph/     k-mer counting, mercy, SdBG, iterate, unitigs, cleaning,
             output
  localasm/  read mapper, mini-assembler, local assembly
  native/    host C++ helpers (g++ at first use), loaded with ctypes
  pipeline/  multi-k driver, options, checkpointing
  utils/     logging, timers, host thread budget, histogram, debug mode,
             the device and route rule
  stage_cli.py  per-stage subcommands (buildlib, count, seq2sdbg, ...)
  tools.py   contig2fastg, filterbylen, readstat
  convert.py megahit_tpu state (as numpy arrays) -> this package's objects
"""

__version__ = "0.1.0"
