"""Decoder LM pieces for the SRF serving slice (dense family)."""
