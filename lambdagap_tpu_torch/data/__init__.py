"""Binning, the binned training matrix and the EFB grouping decision."""
