"""Generators of the port: the note-event front end and the sampler."""
