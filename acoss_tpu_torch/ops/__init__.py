"""Similarity-math ops: CRPs, downsampling and the alignment aligners."""
