"""Numpy oracles: a second check of the port that runs no device code."""
