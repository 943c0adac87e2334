"""Host I/O: FASTA/FASTQ reading, sequence libraries, contig files."""
