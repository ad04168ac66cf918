"""Core: the paper's verb-root-extraction stemmer in PyTorch.

Modules:
  alphabet   — codepoint tables, normalisation, dense 6-bit packing
  pyref      — pure-Python oracle (executable spec)
  stemmer    — batch-parallel PyTorch implementation (5 stages)
  conjugator — verb-form generator (corpus synthesis)
  corpus     — root dictionaries + synthetic Zipf corpus
  textnorm   — host half of the text normaliser (corpus word rows)
  accuracy   — Table 6 analogue harness
"""
