"""Decoder LM pieces for the paged serving path (dense family, full-KV or
SRF attention)."""
