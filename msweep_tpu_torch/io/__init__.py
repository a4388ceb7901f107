"""Host-side I/O: compressed streams, Themisto alignments, grouping files, outputs."""
