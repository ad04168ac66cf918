"""Data pipelines of the port: synthetic LM streams and the stemmer as a
preprocessing operator."""
