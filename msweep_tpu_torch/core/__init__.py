"""Core data model: alignments/equivalence classes, likelihood, samples, binning."""
