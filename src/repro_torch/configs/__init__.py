"""Configurations of the port. ``paper.py`` holds the paper's own system
(the stemmer pipeline); the LM architectures come with the LM substrate."""
