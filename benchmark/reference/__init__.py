"""The plain reference the benchmark holds the port to.

Plain PyTorch, written from the reference simulation's semantics (the
reference's ``source/code/src/particleSystem.cpp`` and the BASELINE emitter
scenes) and frozen here: it imports nothing of the package it judges, and
works out again from the seed everything the package derives from it
(the fill, every frame's random fields, the spawn draws).  Every float
operation takes the dtype it is given, so the same code in ``bfloat16`` is
the control that a comparison has to refuse.
"""
